"""The eager launch path of the three CUDA kernels, written once.

A kernel module states what is its own as a `Kernel`: its names, its
full check, its `layout(key)` (the plan, mode, sizes and outputs of a
key), which arguments are tensors, the order of its C entry point's
pointers and which of them must stay 16-byte aligned. The rest is here:

- `call`, a public wrapper's branch: straight to the launch (or the
  plain version on the CPU) when `direct` finds that nothing traces or
  records the call, and through the `torch.library` op otherwise;
- `launch`, the op's CUDA body and the direct path's launch: the record
  of the call's `key`, built at the key's first launch after the full
  check; a later launch re-checks only what a key leaves open (each
  tensor's dtype, device and layout, and the alignment), allocates the
  outputs, makes one ctypes call and counts `kernels.<k>.launches` (and
  `kernels.<k>.rgb_folds` where the call was given the kernel's `fold`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.autograd.profiler as _profiler

from ...utils import tracing
from . import _build
from .plan import Plan

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# A launch record per key; past this many keys (shapes a long-running
# process has seen) the records are dropped and built again as met.
RECORDS_MAX = 4096
_TENSOR = torch.Tensor
# what `direct` asks on every call, bound once
_compiling = torch.compiler.is_compiling
_dispatch_modes = torch._C._len_torch_dispatch_stack
_function_mode = torch._C._is_torch_function_mode_enabled
_transforms = torch._C._are_functorch_transforms_active
_jit_tracing = torch._C._get_tracing_state
_grad = torch.is_grad_enabled


class Kernel:
    """One kernel's launch data. `check(*args)` raises on what the kernel
    does not take; `layout(key)` gives (plan, mode arguments, sizes after
    the pointers, outputs) of a key whose check passed, each output a
    (shape, dtype or None for the first input's) or None for one not
    allocated. Slots index the op's
    arguments in its schema's order: `tensors` those that are tensors,
    `ins` the entry point's input pointers in its order (the outputs'
    follow), `aligned` the inputs it needs 16-byte aligned. A launch
    returns `outs[returns]`. `fold` is the slot of an optional input, the
    rgb pyramid's image, that each launch given it counts in
    `kernels.<kernel>.rgb_folds`."""

    __slots__ = ("name", "op", "entry", "launches", "direct_launches",
                 "check", "layout", "tensors", "ins", "aligned", "returns",
                 "fold", "folds", "records")

    def __init__(self, kernel: str, name: str, check: Callable,
                 layout: Callable, tensors: tuple, ins: tuple,
                 aligned: tuple, returns, fold: int | None = None):
        self.name = name                       # as its errors name it
        self.op = f"migan::{name}"
        self.entry = f"migan_{kernel}"
        self.launches = f"kernels.{kernel}.launches"
        self.direct_launches = f"kernels.{kernel}.direct_launches"
        self.check, self.layout = check, layout
        self.tensors, self.ins, self.returns = tensors, ins, returns
        self.aligned = tuple(ins.index(i) for i in aligned)   # in `ins`
        self.fold, self.folds = fold, f"kernels.{kernel}.rgb_folds"
        self.records: dict = {}                # key -> Record


class Record(NamedTuple):
    """What every launch of one key passes its C entry point, found once,
    after the launch's checks passed: the arguments before the pointers
    (dtype code, plan, mode) and after them (sizes, flags), the outputs
    to allocate on the first input's device, and what a later call
    re-checks: the slots of the tensors present, their dtype and
    device."""

    fn: Callable
    head: tuple
    tail: tuple
    outs: tuple
    plan: Plan
    dtype: torch.dtype
    index: int                   # the device's, as `Tensor.get_device`
    tensors: tuple


def key(args: tuple) -> tuple:
    """What a launch's record depends on: each of the op's arguments as
    its shape, None or the flag itself, then the first one's dtype and
    device."""
    x = args[0]
    return (*[None if a is None else a.shape if isinstance(a, _TENSOR)
              else a for a in args], x.dtype, x.device)


def record(k: Kernel, at: tuple) -> Record:
    """The launch record of key `at`, whose checks passed."""
    p, mode, tail, outs = k.layout(at)
    dtype, device = at[-2:]
    return Record(getattr(_build.load_library(), k.entry),
                  (DTYPE_CODES[dtype], p.config, p.blocks, p.threads,
                   p.smem_bytes, *mode), tail, outs, p, dtype,
                  -1 if device.index is None else device.index,
                  tuple(i for i in k.tensors if at[i] is not None))


def stream_handle(index: int) -> int:
    """The raw handle of the current stream of CUDA device `index`."""
    return torch._C._cuda_getCurrentRawStream(index)


def launch(k: Kernel, args: tuple):
    """The CUDA kernel's launch (ctypes) on the op's arguments, one count
    per launch (and one rgb fold where `k.fold` was given). The first
    launch of a key runs `k.check` and keeps the key's record (all of
    them dropped past RECORDS_MAX; building a record twice gives the same
    record, so racing threads need no lock). A later one runs `k.check`
    for its error only where what the key leaves open fails: a tensor's
    dtype, device or layout, or an alignment."""
    at = key(args)
    rec = k.records.get(at)
    if rec is None:
        k.check(*args)
        if len(k.records) >= RECORDS_MAX:
            k.records.clear()
        rec = k.records[at] = record(k, at)
    else:
        dtype, index = rec.dtype, rec.index
        for i in rec.tensors:
            t = args[i]
            if (t.dtype is not dtype or t.get_device() != index
                    or not t.is_contiguous()):
                k.check(*args)
                break
    ptrs = [0 if args[i] is None else args[i].data_ptr() for i in k.ins]
    for j in k.aligned:
        if ptrs[j] & 15:
            k.check(*args)
    x = args[0]
    # a dtype argument costs ~0.3 us of host time a call (H100 host,
    # torch 2.11): passed only where it differs from the input's
    outs = [None if o is None else x.new_empty(o[0]) if o[1] is None
            else x.new_empty(o[0], dtype=o[1]) for o in rec.outs]
    err = rec.fn(*rec.head, *ptrs,
                 *[0 if t is None else t.data_ptr() for t in outs],
                 *rec.tail, stream_handle(rec.index))
    if err:
        raise RuntimeError(f"{k.name}: kernel launch failed with CUDA "
                           f"error {err}")
    tracing.add(k.launches)
    if k.fold is not None and args[k.fold] is not None:
        tracing.add(k.folds)
    return outs[k.returns]


def direct(args: tuple, slots: tuple) -> bool:
    """Whether a call on these arguments may go straight to its launch,
    past its op's dispatch: nothing traces, transforms or records it.
    Every tensor (the arguments at `slots`, None skipped) is exactly a
    `torch.Tensor` (no fake, functional or other subclass), nothing
    compiles or traces (`torch.compile`, `torch.export`,
    `torch.jit.trace`), no dispatch mode, function mode or functorch
    transform is active, and no tensor asks for a gradient while grad
    mode is on. Otherwise the call goes through the op, where whatever
    traces or records it sees it."""
    for i in slots:
        t = args[i]
        if t is not None and type(t) is not _TENSOR:
            return False
    if (_compiling() or _dispatch_modes() or _function_mode()
            or _transforms() or _jit_tracing() is not None):
        return False
    return not (_grad()
                and any(args[i] is not None and args[i].requires_grad
                        for i in slots))


def direct_launch(k: Kernel, args: tuple):
    """`launch`, also counted in `kernels.<k>.direct_launches`: a launch
    that skipped the op's dispatch."""
    out = launch(k, args)
    tracing.add(k.direct_launches)
    return out


def call(k: Kernel, op: Callable, plain: Callable, args: tuple):
    """A public wrapper's call on the op's arguments: `op(*args)` unless
    `direct` allows `direct_launch` (CUDA) or `plain(*args)` (CPU)
    without it. While a profiler runs, a direct call sits in a range
    named as the op that holds its arguments, so it leaves the op's event
    (name, shapes, scalars, dtypes). Any device but CPU and CUDA raises:
    an op would hand it, meta included, to its fake and compute
    nothing."""
    x = args[0]
    cuda = x.is_cuda
    if not (cuda or x.is_cpu):
        raise ValueError(f"{k.name}: unsupported device {x.device}")
    if not direct(args, k.tensors):
        return op(*args)
    if not _profiler._is_profiler_enabled:
        return direct_launch(k, args) if cuda else plain(*args)
    with tracing.RANGE(k.op, list(args)):
        return direct_launch(k, args) if cuda else plain(*args)


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
