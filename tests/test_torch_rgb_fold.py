"""`fused_up_block`'s rgb fold on the CPU: with `img_lo`, the image of the
level below, the rgb output is ``upsample2d(img_lo, [1,3,3,1]) + rgb``.

The wrapper runs its plain version here; it is held against the plain
composition the generator ran before the fold (`upsample2d` of the image,
then the add), the op against its fake and schema (`opcheck`), the
checks against what the kernel refuses, and `KernelGenerator` against
the same forward with the pyramid composed outside the kernel. The CUDA
kernel's fold is tested on the card by tests/test_torch_cuda.py.

This file imports no JAX.
"""

import numpy as np
import pytest
import torch

from migan_tpu_torch.models import migan_kernels
from migan_tpu_torch.models.migan_inference import (
    GeneratorConfig, generator_init, resample_filter)
from migan_tpu_torch.models.migan_kernels import KernelGenerator
from migan_tpu_torch.ops.kernels import fused_up_block, upblock
from migan_tpu_torch.ops.upfirdn2d import upsample2d


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The gate runs 6 test workers on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _r(g, *shape, scale=1.0):
    return torch.randn(*shape, generator=g) * scale


def _args(n, hl, wl, c=16, o=24, seed=0):
    """upblock's nine tensor arguments and an image of the level below,
    [n, hl, wl, 3]."""
    g = torch.Generator().manual_seed(seed)
    hh, wh = 2 * hl, 2 * wl
    args = (_r(g, n, hl, wl, c), _r(g, n, hh, wh, c), _r(g, hh, wh, scale=0.1),
            _r(g, 3, 3, c, scale=0.3), _r(g, c), _r(g, c, o, scale=0.3),
            _r(g, hh, wh, scale=0.1), _r(g, o, 3, scale=0.2),
            _r(g, 3, scale=0.1))
    return args, _r(g, n, hl, wl, 3)


@pytest.mark.parametrize("emit_features", [True, False])
@pytest.mark.parametrize("n,hl,wl", [(1, 4, 4), (3, 5, 3), (1, 2, 7),
                                     (3, 6, 4)])
def test_fold_equals_the_plain_composition(n, hl, wl, emit_features):
    """rgb with img_lo equals `upsample2d(img_lo, resample_filter())` plus
    the rgb without it, at square and non-square sizes (the borders' zero
    padding), N of 1 and 3; the features do not change."""
    args, img = _args(n, hl, wl, seed=n * 100 + hl * 10 + wl)
    got = fused_up_block(*args, emit_features=emit_features, img_lo=img)
    base = fused_up_block(*args, emit_features=emit_features)
    if emit_features:
        (feat, got), (want_feat, base) = got, base
        assert torch.equal(feat, want_feat)
    want = upsample2d(img, resample_filter()) + base
    assert got.shape == (n, 2 * hl, 2 * wl, 3)
    torch.testing.assert_close(got, want)


def test_fold_with_the_phase_input():
    """The phase input and img_lo together: the fold does not depend on
    how x_lo is up-sampled."""
    args, img = _args(2, 4, 3, seed=7)
    g = torch.Generator().manual_seed(8)
    x4 = _r(g, 2, 4, 3, 4 * args[0].shape[-1])
    phase = (x4, *args[1:])
    got = fused_up_block(*phase, phase_input=True, img_lo=img)
    feat, base = fused_up_block(*phase, phase_input=True)
    torch.testing.assert_close(got[1], upsample2d(img, resample_filter())
                               + base)
    assert torch.equal(got[0], feat)


def _check_args(args, img, **kw):
    """upblock._check's arguments: the nine tensors, emit_features,
    phase_input, img_lo."""
    a = list(args)
    for i, k in ((7, "w_rgb"), (8, "b_rgb")):
        if k in kw:
            a[i] = kw[k]
    return (*a, True, False, img)


def test_check_refuses_a_fold_it_cannot_compute():
    """`_check` refuses img_lo without torgb, of another batch, size or
    channel count, of another dtype or not contiguous; the plain version
    refuses the first three as well."""
    args, img = _args(2, 4, 3)
    upblock._check(*_check_args(args, img))
    with pytest.raises(ValueError, match="img_lo needs w_rgb"):
        upblock._check(*_check_args(args, img, w_rgb=None, b_rgb=None))
    for bad in (img[:1], img[:, :, :2], img[:, :3], img[..., :2]):
        with pytest.raises(ValueError, match="img_lo"):
            upblock._check(*_check_args(args, bad.contiguous()))
        with pytest.raises(ValueError, match="img_lo"):
            fused_up_block(*args, img_lo=bad.contiguous())
    with pytest.raises(ValueError, match="img_lo needs w_rgb"):
        fused_up_block(*args[:7], img_lo=img)
    with pytest.raises(TypeError, match="img_lo is torch.float64"):
        upblock._check(*_check_args(args, img.double()))
    strided = torch.stack([img, img], -1)[..., 0]
    with pytest.raises(ValueError, match="img_lo is not contiguous"):
        upblock._check(*_check_args(args, strided))


@pytest.mark.parametrize("emit_features", [True, False])
def test_fold_op_passes_opcheck(emit_features):
    """`torch.library.opcheck` of the op with img_lo: schema, fake
    implementation and a dynamic-shape trace."""
    args, img = _args(2, 4, 3, c=8, o=16)
    result = torch.library.opcheck(upblock.fused_up_block_op,
                                   (*args, emit_features, False, img))
    assert set(result.values()) == {"SUCCESS"}, result


@pytest.mark.parametrize("res", [256, 512])
def test_kernel_chain_equals_the_unfolded_pyramid(res, monkeypatch):
    """`KernelGenerator` with the fold equals the same chain with the rgb
    pyramid composed outside the kernel, as before the fold
    (`img = upsample2d(img, resample_filter()) + rgb`), within float32
    rounding; every upblock call of the chain passes img_lo."""
    g = generator_init(GeneratorConfig(resolution=res, ch_base=res * 8),
                       torch.Generator().manual_seed(res))
    x = torch.from_numpy(np.random.RandomState(res).randn(1, res, res, 4)
                         .astype(np.float32))
    chain = KernelGenerator(g)
    folded = chain(x)
    folds = []

    def unfolded(*args, img_lo=None, **kw):
        folds.append(img_lo is not None)
        out = fused_up_block(*args, **kw)
        rgb = out if isinstance(out, torch.Tensor) else out[1]
        rgb = upsample2d(img_lo, resample_filter()) + rgb
        return rgb if isinstance(out, torch.Tensor) else (out[0], rgb)

    monkeypatch.setattr(migan_kernels, "fused_up_block", unfolded)
    want = chain(x)
    assert folds == [True] * len(chain.kernel_res)
    assert folded.shape == (1, res, res, 3)
    torch.testing.assert_close(folded, want)
