"""The port's spans and counters, held in process memory.

A span is a named stretch of one thread's work: its start and end
(`time.perf_counter_ns`), its own id, its parent's (the innermost span
open on the same thread) and the request it belongs to, inherited from
the parent unless given; a span opened with `cpu=True` also holds the
thread's CPU time over it (`time.thread_time_ns`). Spans are kept in a
bounded ring; the oldest go first, counted by `dropped()`. `spans()` and
`counters()` read them.

When spans are recorded:
- `span(name)` records only while a `torch.profiler` session runs
  (`torch.autograd.profiler._is_profiler_enabled`), inside a set-up span
  of the same thread, and never while `torch.compiler.is_compiling()`.
  Otherwise it costs one check and records nothing.
- `setup_span(name)` records always (not while compiling): the few
  one-off stretches of a process, such as loading the model and its
  first forward. Spans inside it carry `setup=True`.
- `record(name, start_ns, end_ns, mark)` records a span with explicit
  times, for a wait that crosses threads (`mark()` taken where it
  began); it has no CPU time.

While the profiler runs, each context-manager span is also a record
function range of its name (the profiler's C++ fast path,
`_RecordFunctionFast`), so that it appears on the profiler's timeline
(from the threads the profiler records). The thread's CPU clock is a
system call, so only the spans that are read for it take it.

Counters are named integers, always on: `add(name, n)`. `OpCount` counts
the ops a stretch of code dispatches.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.autograd.profiler as _profiler
from torch.utils._python_dispatch import TorchDispatchMode

RING = 1 << 16

# A profiler range of a name. `torch.profiler.record_function` costs ~10x
# as much a range inside a forward on an H100 host: it calls two ops
# through the dispatcher.
RANGE = torch._C._profiler._RecordFunctionFast


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    cpu_ns: Optional[int]      # the thread's CPU time, if taken
    id: int
    parent: Optional[int]
    request: Any               # a request id, a tuple of them, or None
    setup: bool                # a set-up span, or inside one

    @property
    def wall_ns(self) -> int:
        return self.end_ns - self.start_ns


class Mark(NamedTuple):
    """Where a span that crosses threads began: its start, parent and
    request."""

    start_ns: int
    parent: Optional[int]
    request: Any


_lock = threading.Lock()
_ring: "collections.deque[tuple]" = collections.deque(maxlen=RING)
_dropped = 0
_counts: Dict[str, int] = {}
_ids = itertools.count(1)
_local = threading.local()
_setup_open = 0                # set-up spans open in any thread


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def _save(fields: tuple) -> None:
    """Keep a span's fields, in `Span`'s order."""
    global _dropped
    with _lock:
        if len(_ring) == _ring.maxlen:
            _dropped += 1
        _ring.append(fields)


class _Open:
    """A span being recorded; `span` and `setup_span` hand it out."""

    __slots__ = ("name", "stack", "request", "setup", "opens", "clock",
                 "id", "parent", "start", "cpu", "range")

    def __init__(self, name: str, st: list, request, new_request: bool,
                 opens: bool, clock: bool):
        top = st[-1] if st else None
        self.name, self.stack, self.clock = name, st, clock
        self.id = next(_ids)
        self.parent = top.id if top else None
        self.request = (request if request is not None else self.id
                        if new_request else top.request if top else None)
        self.opens = opens                      # a set-up span itself
        self.setup = opens or (top.setup if top else False)

    def __enter__(self):
        global _setup_open
        self.stack.append(self)
        if self.opens:
            with _lock:
                _setup_open += 1
        self.range = None
        if _profiler._is_profiler_enabled:
            self.range = RANGE(self.name)
            self.range.__enter__()
        self.cpu = time.thread_time_ns() if self.clock else None
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        global _setup_open
        end = time.perf_counter_ns()
        cpu = time.thread_time_ns() - self.cpu if self.clock else None
        if self.range is not None:
            self.range.__exit__(None, None, None)
        self.stack.pop()
        if self.opens:
            with _lock:
                _setup_open -= 1
        _save((self.name, self.start, end, cpu, self.id, self.parent,
               self.request, self.setup))
        return False


# What a span site gets while nothing is recorded; a `nullcontext`, which
# `torch.compile` and strict `torch.export` trace through.
_OFF = contextlib.nullcontext()


def _recording() -> Optional[list]:
    """This thread's stack if a `span` opened now would be recorded (past
    the first check: not while compiling, and without a profiler only
    inside a set-up span of this thread), else None."""
    if torch.compiler.is_compiling():
        return None
    st = _stack()
    if _profiler._is_profiler_enabled or (st and st[-1].setup):
        return st
    return None


def on() -> bool:
    """Whether a `span` opened on this thread now would be recorded."""
    return bool(_profiler._is_profiler_enabled or _setup_open) and \
        _recording() is not None


def span(name: str, request=None, new_request: bool = False,
         cpu: bool = False):
    """A context manager recording `name` while `on()`. `request` names
    the request(s) the span serves; `new_request=True` starts a request
    whose id is the span's own. Children inherit the request. `cpu=True`
    takes the thread's CPU time over the span."""
    if _profiler._is_profiler_enabled or _setup_open:
        st = _recording()
        if st is not None:
            return _Open(name, st, request, new_request, False, cpu)
    return _OFF


def setup_span(name: str):
    """A context manager recording `name` always (not while compiling):
    a one-off stretch of set-up. Spans inside it record too."""
    if torch.compiler.is_compiling():
        return _OFF
    return _Open(name, _stack(), None, False, True, False)


def mark() -> Optional[Mark]:
    """The start of a span that another thread ends, or None while
    nothing is recorded: now, and this thread's innermost span as its
    parent and request."""
    if not on():
        return None
    st = _stack()
    top = st[-1] if st else None
    return Mark(time.perf_counter_ns(), top.id if top else None,
                top.request if top else None)


def record(name: str, start_ns: int, end_ns: int, m: Mark) -> None:
    """Record a span with explicit times under the parent and request of
    the mark `m` (from `mark()`, not None)."""
    _save((name, start_ns, end_ns, None, next(_ids), m.parent, m.request,
           False))


def spans() -> Tuple[Span, ...]:
    """The ring's spans, oldest first."""
    with _lock:
        held = tuple(_ring)
    return tuple(map(Span._make, held))


def dropped() -> int:
    """Spans pushed out of the ring since the last `reset`."""
    return _dropped


def reset() -> None:
    """Empty the ring and zero `dropped()`. Counters stay."""
    global _dropped
    with _lock:
        _ring.clear()
        _dropped = 0


def add(name: str, n: int = 1) -> None:
    """Add n to the counter `name`."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def counters() -> Dict[str, int]:
    """A copy of every counter."""
    with _lock:
        return dict(_counts)


def reset_counters(prefix: str = "") -> None:
    """Zero the counters whose names start with `prefix`."""
    with _lock:
        for k in [k for k in _counts if k.startswith(prefix)]:
            del _counts[k]


class OpCount(TorchDispatchMode):
    """Counts the ops dispatched inside it: `total` every op, aten ops
    and each `migan::` kernel op as one (its plain version runs below the
    mode), `kernels` the `migan::` ones."""

    def __init__(self):
        super().__init__()
        self.total = self.kernels = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.total += 1
        self.kernels += func.namespace == "migan"
        return func(*args, **(kwargs or {}))
