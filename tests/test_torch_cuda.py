"""Each CUDA kernel of `migan_tpu_torch` against its plain PyTorch version on
the card, float32 with TF32 off, at odd sizes that leave ragged tiles.

Marked `cuda`: skips where no CUDA device is present. This file imports
no JAX, so it runs on a machine that has only the port's dependencies:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Tolerance rtol/atol 1e-4: the same float32 sums in another order (atol
1e-3 in the clamp case, whose partial sums reach the hundreds).
"""

import numpy as np
import pytest
import torch

from migan_tpu_torch.ops.kernels import (
    downblock, fused_block, fused_down_block, fused_up_block, sepconv,
    upblock,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _r(rng, *shape, scale=1.0):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32) * scale)


def _sep(rng, c, o):
    """[3,3,C], [C], [C,O] weights."""
    return _r(rng, 3, 3, c, scale=0.3), _r(rng, c), _r(rng, c, o,
                                                       scale=c ** -0.5)


def _on(dev, *ts):
    return [t.to(dev) for t in ts]


@pytest.mark.parametrize("final_act", [True, False])
def test_sepconv_matches_plain(dev, final_act):
    rng = np.random.RandomState(5)
    args = _on(dev, _r(rng, 2, 24, 40, 96), *_sep(rng, 96, 160),
               _r(rng, 24, 40, scale=0.1))
    before = sepconv.COUNTER.count
    got = fused_block(*args, final_act=final_act)
    torch.cuda.synchronize()
    assert sepconv.COUNTER.count == before + 1
    want = sepconv.sepconv_plain(*args, final_act=final_act)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_sepconv_clamp_matches_plain(dev):
    rng = np.random.RandomState(8)
    args = _on(dev, _r(rng, 2, 16, 16, 64, scale=400.0), *_sep(rng, 64, 64))
    want = sepconv.sepconv_plain(*args)
    assert (want.abs() == 256).float().mean() > 0.05
    torch.testing.assert_close(fused_block(*args), want, rtol=1e-4,
                               atol=1e-3)


def test_downblock_matches_plain(dev):
    rng = np.random.RandomState(6)
    args = _on(dev, _r(rng, 2, 24, 40, 96), *_sep(rng, 96, 160))
    before = downblock.COUNTER.count
    got = fused_down_block(*args)
    torch.cuda.synchronize()
    assert downblock.COUNTER.count == before + 1
    torch.testing.assert_close(got, downblock.downblock_plain(*args),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("emit_features", [True, False])
def test_upblock_matches_plain(dev, emit_features):
    rng = np.random.RandomState(7)
    n, hl, wl, c, o = 2, 12, 20, 96, 160
    args = _on(dev, _r(rng, n, hl, wl, c), _r(rng, n, 2 * hl, 2 * wl, c),
               _r(rng, 2 * hl, 2 * wl, scale=0.1), *_sep(rng, c, o),
               _r(rng, 2 * hl, 2 * wl, scale=0.1), _r(rng, o, 3, scale=0.2),
               _r(rng, 3, scale=0.1))
    before = upblock.COUNTER.count
    got = fused_up_block(*args, emit_features=emit_features)
    torch.cuda.synchronize()
    assert upblock.COUNTER.count == before + 1
    want = upblock.upblock_plain(*args, emit_features=emit_features)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    rng = np.random.RandomState(9)
    x, *w = _on(dev, _r(rng, 1, 8, 8, 32), *_sep(rng, 32, 32))
    with pytest.raises(TypeError):
        fused_block(x.double(), *(t.double() for t in w))
    with pytest.raises(ValueError, match="contiguous"):
        fused_block(x.permute(0, 2, 1, 3), *w)
    with pytest.raises(ValueError, match="shapes"):
        fused_block(x, w[0], w[1], w[2][:16])
    with pytest.raises(ValueError, match="even"):
        fused_down_block(x[:, :7].contiguous(), *w)


def test_channels_beyond_shared_memory_raise_at_launch(dev):
    """C = 1024 needs ~264 KB of shared memory per block, more than Hopper
    has: the launch reports it and the wrapper raises, counting nothing;
    the next launch of a size that fits still succeeds."""
    rng = np.random.RandomState(10)
    big = _on(dev, _r(rng, 1, 4, 4, 1024), *_sep(rng, 1024, 32))
    before = sepconv.COUNTER.count
    with pytest.raises(RuntimeError, match="CUDA error"):
        fused_block(*big)
    assert sepconv.COUNTER.count == before
    args = _on(dev, _r(rng, 1, 8, 8, 32), *_sep(rng, 32, 32))
    torch.testing.assert_close(fused_block(*args),
                               sepconv.sepconv_plain(*args),
                               rtol=1e-4, atol=1e-4)
