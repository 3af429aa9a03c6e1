"""What a per-layer metric's reader gets, and the arithmetic that several
readers share. A reader is `metrics/<name>.py` with `read(reading)`,
which returns a number or None when the run has nothing for it to read;
the harness then leaves the metric out of the line.

A hand-written kernel is described by `metrics/kernels/<kernel>.json`:
the program's op that launches it and the fragments of its device
kernels' names. Device time outside every described kernel and outside
the copies is the plain ops'.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Optional

from . import profiling
from .reference import work

KERNELS = Path(__file__).resolve().parent / "metrics" / "kernels"
COPY = "Memcpy"


@dataclass
class Reading:
    config: dict
    window: Any                  # the traffic kind's Window
    trace: Optional[profiling.Trace]
    card: Optional[dict]         # reference/peaks.json's entry, if any

    def peak_flops(self) -> float:
        return work.peak_flops(self.card, self.config["dtype"])


def kernels() -> dict:
    return {p.stem: json.loads(p.read_text())
            for p in sorted(KERNELS.glob("*.json"))}


def _matcher(fragments):
    return lambda name: any(f in name for f in fragments)


def plain_ops():
    """Accepts the device events of neither a described kernel nor a
    copy."""
    kernel = _matcher([f for k in kernels().values()
                       for f in k["device_names"]])
    return lambda name: not kernel(name) and not name.startswith(COPY)


def kernel_roofline(r: Reading, kernel: str) -> Optional[float]:
    """The kernel's calls' least time (`work.bound_seconds` from each
    call's recorded shapes) over the device time of its kernels, in %."""
    if r.trace is None or r.card is None:
        return None
    k = kernels()[kernel]
    rows = profiling.op_rows(r.trace, k["op"])
    t = profiling.device_time_s(r.trace, _matcher(k["device_names"]))
    if not rows or t <= 0:
        return None
    bound = sum(work.bound_seconds(r.card, k["op"], shapes, concrete,
                                   dtypes or [r.config["dtype"]])
                for shapes, concrete, dtypes in rows)
    return 100.0 * bound / t


def per_call_ms(r: Reading, match) -> Optional[float]:
    """Device ms per traced call of the events `match` accepts."""
    if r.trace is None or not r.trace.units.get("calls"):
        return None
    return 1e3 * profiling.device_time_s(r.trace, match) / \
        r.trace.units["calls"]


def mfu_pct(r: Reading) -> Optional[float]:
    """The generator FLOPs of the images done in the window over the
    window's time, as a share of the card's tensor peak."""
    w = r.window
    if r.card is None or not w.images:
        return None
    flops = work.generator_flops(r.config, w.images)
    return 100.0 * flops / w.seconds / r.peak_flops()
