"""Native (C++) free-form mask synthesis, the training path's fast masks
(port of `migan_tpu/data/fast_masks.py`): the RandomMask algorithm
rasterized in C++ (`csrc/host/maskgen.cpp`, the port's copy of the JAX
package's `native/maskgen.cpp`), for the same seed the same mask as the
JAX package's, bit for bit. Not the PIL generator's masks
(`data/masks.py`, the bit-exact oracle of the evaluation protocol): the
same distribution of shapes, other pixels.

The shared library is built at first use with `g++ -O3 -shared -fPIC`
into `build/native/` at the repository root (listed in `.gitignore`),
named by a hash of the source and the compiler command, under a file
lock (`utils/native_build.py`), and loaded with ctypes. Unlike the JAX
package, a failed build raises with the compiler's output: it never
falls back to PIL masks, which would be other masks for the same seed.
Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from ..utils import native_build

_PKG = Path(__file__).resolve().parents[1]           # migan_tpu_torch/
SOURCE = _PKG / "csrc" / "host" / "maskgen.cpp"
BUILD_DIR = _PKG.parent / "build" / "native"
CXX = "g++"
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_U8P = ctypes.POINTER(ctypes.c_uint8)


def library_path() -> Path:
    return native_build.hashed_path(BUILD_DIR, "maskgen",
                                    [CXX, *CXX_FLAGS], [SOURCE])


def build() -> Path:
    """Compile the rasterizer unless a library of the same source and
    compiler command exists; returns its path. Raises RuntimeError when
    the compiler is missing or fails."""

    def compile_into(tmp: str) -> str:
        so = os.path.join(tmp, "libmaskgen.so")
        cmd = [CXX, *CXX_FLAGS, "-o", so, str(SOURCE)]
        try:
            r = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"mask rasterizer build: cannot run "
                               f"{CXX!r}: {e}") from e
        if r.returncode != 0:
            raise RuntimeError(
                f"mask rasterizer build failed ({r.returncode}):\n"
                f"{' '.join(cmd)}\n{r.stdout}{r.stderr}")
        return so

    return native_build.build_once(library_path(), compile_into)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the rasterizer, with the JAX package's
    ctypes signatures."""
    lib = ctypes.CDLL(str(build()))
    lib.generate_mask.restype = ctypes.c_double
    lib.generate_mask.argtypes = [_U8P, ctypes.c_int, ctypes.c_uint64,
                                  ctypes.c_double, ctypes.c_double]
    lib.generate_masks.restype = None
    lib.generate_masks.argtypes = [_U8P, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_uint64, ctypes.c_double,
                                   ctypes.c_double]
    return lib


def fast_random_mask(s: int, hole_range=(0.0, 1.0),
                     seed: Optional[int] = None,
                     rng=np.random) -> np.ndarray:
    """float32 [s, s] mask, 1 = known, 0 = hole. Without a seed, one is
    drawn from `rng` as the JAX package draws it (`randint(0, 2**63 - 1)`):
    pass the DataLoader's per-item RandomState for a stream independent of
    the worker count.

    When 64 tries miss `hole_range`, the rasterizer gives up and the mask
    is the PIL generator's from `RandomState(seed % 2**32)`, as in the JAX
    package: a fixed function of the seed, whatever the machine."""
    lib = load_library()
    if seed is None:
        seed = rng.randint(0, 2 ** 63 - 1)
    out = np.empty((s, s), np.uint8)
    ratio = lib.generate_mask(out.ctypes.data_as(_U8P), s,
                              ctypes.c_uint64(seed), float(hole_range[0]),
                              float(hole_range[1]))
    if ratio >= 0:
        return out.astype(np.float32)
    from .masks import RandomMask

    return RandomMask(s, tuple(hole_range),
                      rng=np.random.RandomState(seed % (2 ** 32)))


def fast_random_masks(n: int, s: int, hole_range=(0.0, 1.0),
                      seed: int = 0, dtype=np.float32) -> np.ndarray:
    """[n, s, s] masks (1 = known, 0 = hole) of seeds seed .. seed + n - 1,
    in one native call; dtype=np.uint8 skips the float conversion. A mask
    whose 64 tries all missed `hole_range` keeps its last try here (the
    C side's batched entry point), as in the JAX package."""
    out = np.empty((n, s, s), np.uint8)
    load_library().generate_masks(out.ctypes.data_as(_U8P), n, s,
                                  ctypes.c_uint64(seed),
                                  float(hole_range[0]),
                                  float(hole_range[1]))
    return out if dtype == np.uint8 else out.astype(dtype)
