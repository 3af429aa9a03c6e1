"""The port's native mask rasterizer (`migan_tpu_torch/data/fast_masks.py`,
its own copy of `native/maskgen.cpp`) against `migan_tpu.data.fast_masks`
on the CPU: the same masks bit for bit (exact comparison) for the same
seeds, at 64, 256 and 512 px and three hole ranges, one at a time, from a
per-item RandomState and batched, in float32 and uint8; the hole ranges
respected; a build whose compiler is missing or fails raises with its
output and never returns PIL masks. Skips without g++ (both packages
build the same source with it).
"""

import os
import shutil
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from migan_tpu.data import fast_masks as jfm
from migan_tpu_torch.data import fast_masks as tfm
from migan_tpu_torch.utils import native_build

SIZES = (64, 256, 512)
HOLE_RANGES = ((0.0, 1.0), (0.1, 0.3), (0.4, 0.6))
SEEDS = range(5)


@pytest.fixture(autouse=True)
def _gxx():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the rasterizer cannot be built here")


@pytest.mark.parametrize("hole_range", HOLE_RANGES)
@pytest.mark.parametrize("s", SIZES)
def test_native_masks_bit_equal_to_jax(s, hole_range):
    for seed in SEEDS:
        got = tfm.fast_random_mask(s, hole_range, seed=seed)
        want = jfm.fast_random_mask(s, hole_range, seed=seed)
        assert got.dtype == want.dtype == np.float32
        assert got.shape == (s, s)
        np.testing.assert_array_equal(got, want)
    # the per-item seed drawn from the loader's RandomState
    got = tfm.fast_random_mask(s, hole_range, rng=np.random.RandomState(7))
    want = jfm.fast_random_mask(s, hole_range, rng=np.random.RandomState(7))
    np.testing.assert_array_equal(got, want)
    for dtype in (np.float32, np.uint8):
        got = tfm.fast_random_masks(4, s, hole_range, seed=11, dtype=dtype)
        want = jfm.fast_random_masks(4, s, hole_range, seed=11, dtype=dtype)
        assert got.dtype == want.dtype == dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hole_range", HOLE_RANGES)
def test_hole_ranges_respected(hole_range):
    lo, hi = hole_range
    for seed in range(20):
        m = tfm.fast_random_mask(128, hole_range, seed=seed)
        assert set(np.unique(m)) <= {0.0, 1.0}
        assert lo < 1 - m.mean() < hi


def test_uint8_batch_is_the_float_batch():
    u8 = tfm.fast_random_masks(3, 96, seed=2, dtype=np.uint8)
    f32 = tfm.fast_random_masks(3, 96, seed=2)
    assert u8.dtype == np.uint8 and set(np.unique(u8)) <= {0, 1}
    np.testing.assert_array_equal(u8.astype(np.float32), f32)
    for i in range(3):
        np.testing.assert_array_equal(
            f32[i], tfm.fast_random_mask(96, seed=2 + i))


@pytest.mark.parametrize("fault", ["missing compiler", "compile error"])
def test_failed_build_raises(tmp_path, monkeypatch, fault):
    """No PIL masks in place of the rasterizer's: the build raises, and
    so does every mask call."""
    monkeypatch.setattr(tfm, "BUILD_DIR", tmp_path / "native")
    if fault == "missing compiler":
        monkeypatch.setattr(tfm, "CXX", str(tmp_path / "no-such-g++"))
        match = "cannot run"
    else:
        monkeypatch.setattr(tfm, "CXX_FLAGS",
                            tfm.CXX_FLAGS + ["-DMASKGEN_BROKEN", "-include",
                                             str(tmp_path / "missing.h")])
        match = "missing.h"
    tfm.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match=match):
            tfm.fast_random_mask(64, seed=0)
        with pytest.raises(RuntimeError, match=match):
            tfm.fast_random_masks(2, 64)
        assert not list((tmp_path / "native").glob("*.so"))
    finally:
        tfm.load_library.cache_clear()


def test_library_keyed_on_compiler_command(monkeypatch):
    """Another compiler names another library: a stale one of the same
    source and flags is never loaded."""
    base = tfm.library_path()
    monkeypatch.setattr(tfm, "CXX", "clang++")
    assert tfm.library_path() != base
    monkeypatch.setattr(tfm, "CXX", "g++")
    assert tfm.library_path() == base


def test_concurrent_builds_compile_once(tmp_path):
    """Threads that build the same library together wait on the lock: one
    compiles, all get the library."""
    calls = []

    def compile_into(tmp):
        calls.append(tmp)
        time.sleep(0.2)
        so = os.path.join(tmp, "lib.so")
        with open(so, "w") as f:
            f.write("library")
        return so

    out = tmp_path / "build" / "libx_0123.so"
    with ThreadPoolExecutor(4) as ex:
        got = list(ex.map(lambda _: native_build.build_once(out, compile_into),
                          range(4)))
    assert got == [out] * 4 and len(calls) == 1
    assert out.read_text() == "library"
    assert sorted(p.name for p in out.parent.iterdir()) == ["libx_0123.so",
                                                           "lock"]
