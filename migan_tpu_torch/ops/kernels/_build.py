"""Build and load the CUDA kernels of `migan_tpu_torch/csrc/`.

The `.cu` files have plain C entry points. At first use they are compiled
with nvcc for sm_90a, one nvcc process per file, all started together, and
linked into one shared library under `build/kernels/` at the repository
root (listed in `.gitignore`), named by a hash of the sources and the
compiler command, under a file lock (`utils/native_build.py`), and
loaded with ctypes. Nothing here runs at import time, and
nothing is built for CPU tensors.

Also the launch path the three kernel modules share: `direct` decides
whether a call may skip its `torch.library` op, `run` keeps the op's
profiler event for such a call, and a `Record` holds what every launch
of one key passes its kernel (see `ops/kernels/__init__.py`).
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
from pathlib import Path
from typing import Callable, NamedTuple

import torch
import torch.autograd.profiler as _profiler

from ...utils import native_build, tracing
from .plan import Plan

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

# A launch record per key; past this many keys (shapes a long-running
# process has seen) the records are dropped and built again as met.
RECORDS_MAX = 4096
_TENSOR = torch.Tensor
# The profiler's C++ range, as `utils/tracing.py` uses it
_RANGE = torch._C._profiler._RecordFunctionFast


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
    if not (t.is_cuda or t.is_cpu):
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


def stream_handle(index: int) -> int:
    """The raw handle of the current stream of CUDA device `index`."""
    return torch._C._cuda_getCurrentRawStream(index)


class Record(NamedTuple):
    """What every launch of one key (a kernel's shapes, flags, dtype and
    device) passes its C entry point, found once, after the launch's
    checks passed: the arguments before the tensors' pointers (dtype
    code, plan, mode) and after them (sizes, flags), and the outputs'
    shapes (None for one not allocated), which a launch allocates like
    its first input."""

    fn: Callable
    head: tuple
    tail: tuple
    out_shapes: tuple
    plan: Plan
    dtype: torch.dtype
    index: int                   # the device's, as `Tensor.get_device`


def device_index(device: torch.device) -> int:
    """`Tensor.get_device` of a tensor on `device`."""
    return -1 if device.index is None else device.index


def in_place(rec: Record, tensors) -> bool:
    """Whether each tensor (None skipped) has the record's dtype, lies on
    its device and is contiguous: what a key does not fix of a call."""
    dtype, index = rec.dtype, rec.index
    for t in tensors:
        if t is not None and (t.dtype is not dtype
                              or t.get_device() != index
                              or not t.is_contiguous()):
            return False
    return True


def remember(records: dict, key, rec: Record) -> Record:
    """Keep `rec` under `key`, dropping every record past RECORDS_MAX.
    Building a record twice gives the same record, so threads that race
    here need no lock."""
    if len(records) >= RECORDS_MAX:
        records.clear()
    records[key] = rec
    return rec


def direct(*tensors) -> bool:
    """Whether a call on these arguments may go straight to its launch,
    past its op's dispatch: nothing traces, transforms or records it.
    Every tensor (None skipped) is exactly a `torch.Tensor` (no fake,
    functional or other subclass), nothing compiles or traces
    (`torch.compile`, `torch.export`, `torch.jit.trace`), no dispatch
    mode, function mode or functorch transform is active, and no tensor
    asks for a gradient while grad mode is on. Otherwise the call goes
    through the op, where whatever traces or records it sees it."""
    for t in tensors:
        if t is not None and type(t) is not _TENSOR:
            return False
    if (torch.compiler.is_compiling()
            or torch._C._len_torch_dispatch_stack()
            or torch._C._is_torch_function_mode_enabled()
            or torch._C._are_functorch_transforms_active()
            or torch._C._get_tracing_state() is not None):
        return False
    return not (torch.is_grad_enabled()
                and any(t is not None and t.requires_grad for t in tensors))


def run(op: str, impl: Callable, args: tuple):
    """impl(*args); while a profiler runs, inside a range named `op` that
    holds args, the op's arguments in its schema's order, so that a
    direct call leaves the event (name, shapes, scalars, dtypes) that the
    op's own call would."""
    if _profiler._is_profiler_enabled:
        with _RANGE(op, list(args)):
            return impl(*args)
    return impl(*args)
