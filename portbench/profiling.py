"""The traced stretch of a `--trace 1` run: `torch.profiler` over a
window span of the benchmark's own, reduced to plain lists that the
metric readers take.

`busy_union` and the window logic are copied from the program's
`cli/trace.py`: the device is busy where any device event runs, counted
once however many overlap, and only inside the window span, which
encloses the stretch's work and its final synchronize, so a busy share
cannot pass 100%. Chrome traces are not written.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

WINDOW = "portbench.window"
# The benchmark's own spans, around its calls into the program.
SPANS = ("forward", "d2h")
KERNEL_PREFIX = "migan::"


@dataclass
class Trace:
    """One traced stretch, in microseconds of the profiler's clock."""

    window: Tuple[float, float]
    device: List[Tuple[str, float, float]]     # (name, start, end)
    ops: List[Tuple[str, list, list, list]]   # (op, shapes, scalars, dtypes)
    spans: List[Tuple[str, float, float]]      # the benchmark's spans
    units: Dict[str, float] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_s(self) -> float:
        return busy_union([(s, e) for _, s, e in self.device],
                          self.window) / 1e6


def busy_union(intervals, window) -> float:
    """Length of the union of the (start, end) intervals, each clipped to
    window = (lo, hi)."""
    lo, hi = window
    total, cur = 0.0, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur is None or s > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        total += cur[1] - cur[0]
    return total


def idle_gaps(intervals, window) -> List[Tuple[float, float]]:
    """The (start, end) stretches of the window in which no interval
    runs, longest first."""
    lo, hi = window
    gaps, t = [], lo
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return sorted(gaps, key=lambda g: g[0] - g[1])


@contextmanager
def stretch():
    """Profile the body; afterwards the yielded dict holds the `Trace`
    under "trace". The window span ends after a synchronize, so it
    encloses the stretch's device work."""
    from torch.profiler import ProfilerActivity, profile, record_function

    holder: Dict[str, Trace] = {}
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   record_shapes=True)
    prof.start()
    try:
        with record_function(WINDOW):
            yield holder
            torch.cuda.synchronize()
    finally:
        prof.stop()
    holder["trace"] = extract(prof)


def extract(prof) -> Trace:
    from torch.autograd import DeviceType

    events = prof.events()
    win = next(e for e in events
               if e.name == WINDOW and e.device_type == DeviceType.CPU)
    lo, hi = win.time_range.start, win.time_range.end
    ours = set(SPANS) | {WINDOW}
    device, ops, spans = [], [], []
    for e in events:
        t0, t1 = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if e.name not in ours and not getattr(e, "is_user_annotation",
                                                  False):
                device.append((e.name, t0, t1))
        elif e.name in SPANS:
            spans.append((e.name, t0, t1))
        elif e.name.startswith(KERNEL_PREFIX) and lo <= t0 <= hi:
            ops.append((e.name, list(e.input_shapes or []),
                        list(e.concrete_inputs or []),
                        list(getattr(e, "input_dtypes", None) or [])))
    if not device:
        raise RuntimeError("the profiler recorded no device events")
    return Trace((lo, hi), device, ops, spans)


def device_time_s(trace: Trace, match) -> float:
    """Seconds of the window's device events whose name `match` accepts
    (each clipped to the window)."""
    lo, hi = trace.window
    return sum(max(0.0, min(e, hi) - max(s, lo))
               for n, s, e in trace.device if match(n)) / 1e6


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device ops that took most time, and the longest idle gaps,
    each named by the benchmark's span the host was in at its middle."""
    lo, hi = trace.window
    by_name: Dict[str, float] = {}
    for n, s, e in trace.device:
        by_name[n] = by_name.get(n, 0.0) + max(0.0, min(e, hi) - max(s, lo))
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = []
    for s, e in idle_gaps([(a, b) for _, a, b in trace.device],
                          trace.window)[:top]:
        mid = (s + e) / 2
        inside = [n for n, a, b in trace.spans if a <= mid <= b]
        gaps.append([f"idle in {inside[-1] if inside else 'other host work'}",
                     (e - s) / 1e6])
    return {"device_ops": [[n[:120], t / 1e6] for n, t in ops],
            "idle_gaps": gaps}


def op_rows(trace: Trace, op: str) -> List[Tuple[list, list, list]]:
    """(shapes, concrete, dtypes) of every call of `op` in the window."""
    return [(sh, co, dt) for n, sh, co, dt in trace.ops if n == op]
