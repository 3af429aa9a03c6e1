"""Build and load the CUDA kernels of `migan_tpu_torch/csrc/`.

The `.cu` files have plain C entry points. At first use they are compiled
with nvcc for sm_90a, one nvcc process per file, all started together, and
linked into one shared library under `build/kernels/` at the repository
root (listed in `.gitignore`), named by a hash of the sources and the
compiler command, under a file lock (`utils/native_build.py`), and
loaded with ctypes. Nothing here runs at import time, and
nothing is built for CPU tensors. How a call reaches an entry point is
`launch.py`'s.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
from pathlib import Path

from ...utils import native_build, tracing

_PKG = Path(__file__).resolve().parents[2]           # migan_tpu_torch/
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry point -> argument types (each returns the launch's CUDA error).
SIGNATURES = {
    "migan_sepconv": [_I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                      _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "migan_downblock": [_I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I,
                        _I, _I, _P],
    "migan_upblock": [_I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                      _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (nvcc); set CUDA_HOME")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    cu, cuh = _sources()
    return native_build.hashed_path(BUILD_DIR, "migan_kernels",
                                    [_nvcc(), *NVCC_FLAGS], cu + cuh)


def build() -> Path:
    """Compile the kernels unless a library of the same sources and
    compiler exists. Returns the library's path."""
    cu, _ = _sources()
    nvcc = _nvcc()

    def compile_into(tmp: str) -> str:
        objs = [os.path.join(tmp, f"{p.stem}.o") for p in cu]
        cmds = [[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o",
                 obj] for src, obj in zip(cu, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        # wait for every compile before reporting any failure
        logs = [p.communicate()[0] for p in procs]
        for cmd, p, log in zip(cmds, procs, logs):
            _check(cmd, p.returncode, log)
        so = os.path.join(tmp, "lib.so")
        cmd = [nvcc, *ARCH, "-shared", *objs, "-o", so]
        r = subprocess.run(cmd, capture_output=True, text=True)
        _check(cmd, r.returncode, r.stdout + r.stderr)
        return so

    return native_build.build_once(library_path(), compile_into)


def _check(cmd, returncode: int, log: str) -> None:
    if returncode != 0:
        raise RuntimeError(f"nvcc failed ({returncode}):\n{' '.join(cmd)}"
                           f"\n{log}")


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every entry
    point's argument types declared: the set-up span
    `kernels.load_library`."""
    with tracing.setup_span("kernels.load_library"):
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib
