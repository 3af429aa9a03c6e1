"""Tiny runs on the CPU for the tests: migan-32 (one kernel level, the
kernels' plain versions) with the real limits' shape of check."""

from __future__ import annotations

import time
from pathlib import Path

from portbench import harness
from portbench import run as prun

ROOT = Path(__file__).resolve().parents[2]
CONFIG = dict(name="migan-32", model_name="migan-32", resolution=32,
              ch_base=32768, ch_max=512, ic_n=4, rgb_n=3, dtype="float32")
BATCH = dict(kind="closed_loop", batch=4, pool=8, hole=[0.1, 0.6],
             warmup_calls=1, trace_calls=2)
# more warm-up requests than bodies: the sender cycles through them
SERVE = dict(kind="open_loop", rate=20.0, pool=12,
             sizes=[[48, 36], [64, 64], [40, 40]], mask="stroke",
             hole=[0.1, 0.4], jpeg_quality=90, warmup=14,
             trace_seconds=1.0)


def limits(cell: str) -> dict:
    """The committed limits of a cell, with its sample size."""
    return harness._json(ROOT / "portbench" / "workloads" / f"{cell}.json")


def run(mix: dict, cell: str, seed: int = 2 ** 31 + 9,
        seconds: float = 1.0, wrap=None) -> dict:
    e2e = [{"name": "setup_s", "unit": "s"}]
    r = harness.Run(ROOT, {"name": cell, "chips": 1}, CONFIG, mix,
                    limits(cell), seed, seconds, False, "cpu", e2e, [],
                    wrap=wrap)
    return prun.execute(r, time.perf_counter())
