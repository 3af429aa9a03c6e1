"""The port's eager ops (`migan_tpu_torch.ops`) against `migan_tpu.ops` on the
same numpy inputs, on the CPU. Tolerance rtol = atol = 1e-5: both sides are
float32 convolutions that differ only in summation order."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from migan_tpu import ops as jops
from migan_tpu_torch import ops as tops

RTOL = ATOL = 1e-5


def _x(shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _both(fn_j, fn_t, x, *args, **kw):
    want = np.asarray(fn_j(jnp.asarray(x), *args[0], **kw))
    got = fn_t(torch.from_numpy(x), *args[1], **kw).numpy()
    return got, want


@pytest.mark.parametrize("taps", [[1, 3, 3, 1], [1, 2, 1], [1] * 8, None])
@pytest.mark.parametrize("up,down,padding", [
    (1, 1, 0), (2, 1, (2, 1, 2, 1)), (1, 2, 1), (2, 2, (1, 2, 0, 1)),
    (1, 1, (-1, 2, 1, -1)),
])
def test_upfirdn2d_matches_jax(taps, up, down, padding):
    x = _x((2, 9, 12, 5))
    fj = jops.setup_filter(taps)
    ft = tops.setup_filter(taps)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=0, atol=0)
    got, want = _both(jops.upfirdn2d, tops.upfirdn2d, x, (fj,), (ft,),
                      up=up, down=down, padding=padding, gain=1.5)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", [(2, 8, 8, 3), (1, 16, 6, 64)])
def test_upsample_downsample_match_jax(shape):
    x = _x(shape, seed=1)
    fj, ft = jops.setup_filter([1, 3, 3, 1]), tops.setup_filter([1, 3, 3, 1])
    for fn_j, fn_t in ((jops.upsample2d, tops.upsample2d),
                       (jops.downsample2d, tops.downsample2d)):
        got, want = _both(fn_j, fn_t, x, (fj,), (ft,))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_lrelu_agc_matches_jax_and_clamps():
    # scaled so that the +-256 clamp fires on both sides
    x = _x((4, 1000), seed=2, scale=300.0)
    got = tops.lrelu_agc(alpha=0.2, gain="sqrt_2", clamp=256)(
        torch.from_numpy(x)).numpy()
    want = np.asarray(jops.lrelu_agc(alpha=0.2, gain="sqrt_2", clamp=256)(
        jnp.asarray(x)))
    assert (np.abs(want) == 256).sum() > 100
    assert (got == 256).any() and (got == -256).any()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # other slope, gain and clamp
    got = tops.lrelu_agc(alpha=0.1, gain=1.5, clamp=8)(
        torch.from_numpy(x)).numpy()
    want = np.asarray(jops.lrelu_agc(alpha=0.1, gain=1.5, clamp=8)(
        jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k,groups,padding,stride", [
    (3, 1, 1, 1), (3, 6, 1, 1), (1, 1, 0, 1), (3, 2, ((1, 0), (2, 1)), 2),
])
def test_conv2d_matches_jax(k, groups, padding, stride):
    x = _x((2, 10, 9, 6), seed=3)
    w = _x((k, k, 6 // groups, 4 if groups == 1 else 6), seed=4, scale=0.3)
    want = np.asarray(jops.conv2d(jnp.asarray(x), jnp.asarray(w),
                                  stride=stride, padding=padding,
                                  groups=groups))
    got = tops.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                      stride=stride, padding=padding, groups=groups).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
