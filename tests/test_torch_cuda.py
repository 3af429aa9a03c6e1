"""Each CUDA kernel of `migan_tpu_torch` against its plain PyTorch version on
the card: float32 with TF32 off at odd sizes that leave ragged tiles, and
sepconv and downblock at every main-path shape of migan-512 in float32 and
bfloat16.

Marked `cuda`: skips where no CUDA device is present. This file imports
no JAX, so it runs on a machine that has only the port's dependencies:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Tolerances: float32 rtol/atol 1e-4, the same float32 sums in another order
(the kernels' three-pass TF32 product keeps ~22 bits; atol 1e-3 in the
clamp case, whose partial sums reach the hundreds). bfloat16 atol 0.05 +
rtol 0.02: the kernels keep f32 where the plain path rounds after each of
its ~6 ops (bf16 keeps 8 bits).
"""

import numpy as np
import pytest
import torch

from migan_tpu_torch.models.migan_inference import GeneratorConfig
from migan_tpu_torch.models.migan_kernels import kernel_shapes
from migan_tpu_torch.ops.kernels import (
    downblock, fused_block, fused_down_block, fused_up_block, sepconv,
    upblock,
)

TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (5e-2, 2e-2)}
# sepconv and downblock launches of one migan-512 forward, deduplicated
MAIN_SHAPES = sorted({s for s in kernel_shapes(GeneratorConfig(resolution=512))
                      if s[0] != "upblock"}, key=str)

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


def _on(dev, *ts, dtype=torch.float32):
    return [t.to(dev, dtype) for t in ts]


def _close(got, want, dtype):
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


def _held(dev, kernel, args, dtype, **kw):
    """Launch `kernel` ("sepconv" or "downblock") once, check that it
    counted one launch, and hold it against its plain version."""
    mod, fused, plain = {
        "sepconv": (sepconv, fused_block, sepconv.sepconv_plain),
        "downblock": (downblock, fused_down_block,
                      downblock.downblock_plain)}[kernel]
    before = mod.COUNTER.count
    got = fused(*args, **kw)
    torch.cuda.synchronize()
    assert mod.COUNTER.count == before + 1
    _close(got, plain(*args, **kw), dtype)


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
    """upblock keeps all C channels of its tile in shared memory: C = 1024
    needs ~264 KB per block, more than Hopper has. The launch reports it
    and the wrapper raises, counting nothing; the next launch of a size
    that fits still succeeds."""
    rng = np.random.RandomState(10)
    n, hl, c, o = 1, 2, 1024, 32
    big = _on(dev, _r(rng, n, hl, hl, c), _r(rng, n, 2 * hl, 2 * hl, c),
              _r(rng, 2 * hl, 2 * hl, scale=0.1), *_sep(rng, c, o))
    before = upblock.COUNTER.count
    with pytest.raises(RuntimeError, match="CUDA error"):
        fused_up_block(*big)
    assert upblock.COUNTER.count == before
    c = 32
    args = _on(dev, _r(rng, n, hl, hl, c), _r(rng, n, 2 * hl, 2 * hl, c),
               _r(rng, 2 * hl, 2 * hl, scale=0.1), *_sep(rng, c, o))
    torch.testing.assert_close(fused_up_block(*args),
                               upblock.upblock_plain(*args),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kernel", ["sepconv", "downblock"])
def test_channels_stream_in_chunks_at_1024(dev, kernel):
    """sepconv and downblock stream C through shared memory in chunks, so
    C = 1024 runs and matches the plain version."""
    rng = np.random.RandomState(11)
    args = _on(dev, _r(rng, 1, 8, 12, 1024), *_sep(rng, 1024, 64))
    _held(dev, kernel, args, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", MAIN_SHAPES,
                         ids=lambda s: "{}-{}x{}-{}to{}-{}".format(*s))
def test_main_path_shapes_match_plain(dev, shape, dtype):
    """Every sepconv and downblock shape of a migan-512 forward, N = 1."""
    kernel, h, w, c, o, final_act = shape
    rng = np.random.RandomState(h + c + o)
    args = _on(dev, _r(rng, 1, h, w, c), *_sep(rng, c, o), dtype=dtype)
    kw = {} if final_act is None else {"final_act": final_act}
    _held(dev, kernel, args, dtype, **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n,h,w,c,o", [
    (1, 26, 42, 128, 64),    # O below the large tiles' 128
    (3, 18, 10, 96, 160),    # C and O not multiples of the tiles
    (2, 6, 14, 40, 24),      # one ragged K chunk, O below every tile
])
def test_ragged_tiles_match_plain(dev, n, h, w, c, o, dtype):
    """Odd H and W (ragged pixel tiles), C and O that are not multiples of
    the tiles, for both kernels, with noise for sepconv."""
    rng = np.random.RandomState(c + o)
    x, *wts = _on(dev, _r(rng, n, h, w, c), *_sep(rng, c, o), dtype=dtype)
    noise = _on(dev, _r(rng, h, w, scale=0.1), dtype=dtype)[0]
    for fa in (True, False):
        _held(dev, "sepconv", (x, *wts, noise), dtype, final_act=fa)
    _held(dev, "downblock", (x, *wts), dtype)


def test_wrappers_refuse_widths_the_kernels_do_not_take(dev):
    """O must be a multiple of 8 (the weights arrive as 16-byte vectors):
    the wrapper raises before it launches, counting nothing."""
    rng = np.random.RandomState(12)
    args = _on(dev, _r(rng, 1, 8, 8, 32), *_sep(rng, 32, 36))
    before = (sepconv.COUNTER.count, downblock.COUNTER.count)
    with pytest.raises(ValueError, match="multiples of 8"):
        fused_block(*args)
    with pytest.raises(ValueError, match="multiples of 8"):
        fused_down_block(*args)
    assert (sepconv.COUNTER.count, downblock.COUNTER.count) == before
