"""The port's fused ops against the JAX Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; it is held against
the Pallas kernel run with interpret=True, at the kernel-eligible shapes of
tests/test_pallas_{sepconv,packedblock,downblock,upblock}.py and at their
tolerance (rtol 1e-4, atol 1e-5; 1e-4 where those tests use it): both are
float32 with the same taps, summed in another order.

The CUDA kernels themselves are tested on the card by
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from migan_tpu.ops.pallas.downblock import fused_down_block as j_down
from migan_tpu.ops.pallas.packedblock import fused_block_packed as j_packed
from migan_tpu.ops.pallas.sepconv import fused_block as j_sep
from migan_tpu.ops.pallas.upblock import fused_up_block as j_up
from migan_tpu_torch.ops.kernels import (
    fused_block, fused_down_block, fused_up_block,
)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The gate runs 6 test workers on one host: torch's default of one
    thread per core in each of them oversubscribes it several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _weights(rng, c, o, pw_scale=0.3):
    """HWIO weights as the JAX tests make them."""
    return (rng.randn(3, 3, 1, c).astype(np.float32) * 0.3,
            rng.randn(c).astype(np.float32),
            rng.randn(1, 1, c, o).astype(np.float32) * pw_scale)


def _port(w_dw, b_dw, w_pw):
    """The kernels' layout: [3,3,C], [C], [C,O]."""
    return (torch.from_numpy(np.ascontiguousarray(w_dw[:, :, 0])),
            torch.from_numpy(b_dw),
            torch.from_numpy(np.ascontiguousarray(w_pw[0, 0])))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("shape,use_noise", [
    ((2, 32, 32, 128, 64), False),
    ((2, 64, 64, 128, 64), True),
    ((4, 16, 32, 128, 128), True),
])
def test_fused_block_vs_pallas_sepconv(shape, use_noise):
    n, h, w, c, o = shape
    rng = np.random.RandomState(0)
    x = rng.randn(n, h, w, c).astype(np.float32)
    wts = _weights(rng, c, o)
    noise = (rng.randn(h, w).astype(np.float32) * 0.1) if use_noise else None
    want = np.asarray(j_sep(jnp.asarray(x), *map(jnp.asarray, wts),
                            noise=None if noise is None else
                            jnp.asarray(noise), interpret=True))
    got = fused_block(_t(x), *_port(*wts),
                      None if noise is None else _t(noise)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape,use_noise,final_act", [
    ((2, 16, 16, 128, 128), False, True),
    ((2, 16, 16, 128, 128), True, False),
    ((1, 32, 16, 128, 256), True, True),
    ((1, 8, 48, 128, 128), False, False),
])
def test_fused_block_vs_pallas_packedblock(shape, use_noise, final_act):
    n, h, w, c, o = shape
    rng = np.random.RandomState(1)
    x = rng.randn(n, h, w, c).astype(np.float32)
    wts = _weights(rng, c, o)
    noise = (rng.randn(h, w).astype(np.float32) * 0.1) if use_noise else None
    want = np.asarray(j_packed(
        jnp.asarray(x.reshape(n * h * w // 2, 2 * c)), n, h, w,
        *map(jnp.asarray, wts),
        noise=None if noise is None else jnp.asarray(noise),
        interpret=True, tile_rows=4, final_act=final_act)).reshape(n, h, w, o)
    got = fused_block(_t(x), *_port(*wts),
                      None if noise is None else _t(noise),
                      final_act=final_act).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", [(2, 16, 32, 128, 128),
                                   (1, 32, 16, 128, 256),
                                   (2, 8, 16, 128, 128)])
def test_fused_down_block_vs_pallas(shape):
    n, hh, wh, c, o = shape
    rng = np.random.RandomState(2)
    x = rng.randn(n, hh, wh, c).astype(np.float32)
    wts = _weights(rng, c, o, pw_scale=0.2)
    want = np.asarray(j_down(jnp.asarray(x), *map(jnp.asarray, wts),
                             interpret=True, tile_rows=2))
    got = fused_down_block(_t(x), *_port(*wts)).numpy()
    assert got.shape == (n, hh // 2, wh // 2, o)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def _up_inputs(shape, seed):
    n, hl, wl, c, o = shape
    rng = np.random.RandomState(seed)
    x_lo = rng.randn(n, hl, wl, c).astype(np.float32)
    skip = rng.randn(n, 2 * hl, 2 * wl, c).astype(np.float32)
    nz_up = rng.randn(2 * hl, 2 * wl).astype(np.float32) * 0.1
    wts = _weights(rng, c, o, pw_scale=0.2)
    nz2 = rng.randn(2 * hl, 2 * wl).astype(np.float32) * 0.1
    w_rgb = rng.randn(1, 1, o, 3).astype(np.float32) * 0.2
    b_rgb = rng.randn(3).astype(np.float32) * 0.1
    return x_lo, skip, nz_up, wts, nz2, w_rgb, b_rgb


@pytest.mark.parametrize("shape,use_noise2", [
    ((2, 8, 16, 128, 128), True),
    ((1, 16, 8, 128, 128), False),
    ((2, 8, 8, 128, 256), True),
])
def test_fused_up_block_vs_pallas(shape, use_noise2):
    x_lo, skip, nz_up, wts, nz2, _, _ = _up_inputs(shape, 3)
    nz2 = nz2 if use_noise2 else None
    want = np.asarray(j_up(jnp.asarray(x_lo), jnp.asarray(skip),
                           jnp.asarray(nz_up), *map(jnp.asarray, wts),
                           None if nz2 is None else jnp.asarray(nz2),
                           interpret=True, tile_rows=4))
    got = fused_up_block(_t(x_lo), _t(skip), _t(nz_up), *_port(*wts),
                         None if nz2 is None else _t(nz2)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("emit_features", [True, False])
def test_fused_up_block_torgb_vs_pallas(emit_features):
    """The torgb epilogue; emit_features=False returns only rgb."""
    shape = (2, 16, 16, 128, 128)
    n, hl, wl, _, o = shape
    x_lo, skip, nz_up, wts, nz2, w_rgb, b_rgb = _up_inputs(shape, 21)
    outs = j_up(jnp.asarray(x_lo), jnp.asarray(skip), jnp.asarray(nz_up),
                *map(jnp.asarray, wts), jnp.asarray(nz2), interpret=True,
                tile_rows=4, w_rgb=jnp.asarray(w_rgb),
                b_rgb=jnp.asarray(b_rgb), emit_features=emit_features)
    got = fused_up_block(_t(x_lo), _t(skip), _t(nz_up), *_port(*wts),
                         _t(nz2), _t(w_rgb[0, 0]), _t(b_rgb),
                         emit_features=emit_features)
    if emit_features:
        np.testing.assert_allclose(got[0].numpy(), np.asarray(outs[0]),
                                   rtol=1e-4, atol=1e-5)
        outs, got = outs[1], got[1]
    # the Pallas kernel returns rgb as w-packed rows [N*Hh*Wl, 2*3]
    want = np.asarray(outs).reshape(n, 2 * hl, 2 * wl, 3)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_fused_block_clamp_vs_pallas():
    """Input scaled until the +-256 clamp of both activations fires. With
    partial sums in the hundreds, float32 sum-order differences reach
    ~3e-4 absolute where outputs cancel to near zero: atol 1e-3."""
    n, h, w, c, o = 2, 32, 32, 128, 64
    rng = np.random.RandomState(9)
    x = rng.randn(n, h, w, c).astype(np.float32) * 400
    wts = _weights(rng, c, o)
    want = np.asarray(j_sep(jnp.asarray(x), *map(jnp.asarray, wts),
                            interpret=True))
    got = fused_block(_t(x), *_port(*wts)).numpy()
    assert (np.abs(want) == 256).mean() > 0.05
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_wrappers_raise_on_unsupported_device():
    """Only a CPU tensor takes the plain version; anything else that is
    not CUDA raises instead of computing somewhere else."""
    x = torch.empty(1, 8, 8, 4, device="meta")
    w = (torch.empty(3, 3, 4, device="meta"), torch.empty(4, device="meta"),
         torch.empty(4, 4, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        fused_block(x, *w)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_down_block(x, *w)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_up_block(x, torch.empty(1, 16, 16, 4, device="meta"),
                       torch.empty(16, 16, device="meta"), *w)


def test_launch_counter_loses_no_concurrent_add():
    """A server launches from its batcher thread while other threads may
    run forwards: a launch's count is one locked read-modify-write of the
    tracer's counter, so 16 threads adding at a tiny switch interval lose
    no update of `launch_counts()`."""
    import sys
    import threading

    from migan_tpu_torch.ops.kernels import launch_counts, sepconv
    from migan_tpu_torch.utils import tracing

    n_threads, n_adds = 16, 5000
    before = launch_counts()["sepconv"]

    def work():
        for _ in range(n_adds):
            tracing.add(sepconv.KERNEL.launches)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert launch_counts()["sepconv"] == before + n_threads * n_adds
