"""Build and load the CUDA kernels of `migan_tpu_torch/csrc/`.

The `.cu` files have plain C entry points. At first use they are compiled
with nvcc for sm_90a, one nvcc process per file, all started together, and
linked into one shared library under `build/kernels/` at the repository
root (listed in `.gitignore`), named by a hash of the sources and the
compiler command, under a file lock (`utils/native_build.py`), and
loaded with ctypes. Nothing here runs at import time, and
nothing is built for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
from pathlib import Path

import torch

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
                      _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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


def check_device(name: str, t: torch.Tensor) -> None:
    """Raise unless t lies on the CPU (the plain version) or a CUDA device
    (the kernel): a custom op would hand any other device, meta included,
    to its fake implementation and compute nothing."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")


def check_cuda_args(name: str, dtype: torch.dtype, device: torch.device,
                    **tensors) -> None:
    """Raise unless every tensor lies on `device`, has `dtype` and is
    contiguous."""
    if dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {dtype} not supported "
                        f"(float32 or bfloat16)")
    for k, t in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name}: {k} on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {k} is {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} is not contiguous")


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def raise_on_error(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
