"""Closed loop, one caller: batches of model inputs from the host through
`load_model`'s forward and back to the host with `.cpu()`, the next call
as soon as the last has returned.

Mix parameters: `batch` images a call; `pool` distinct image and mask
pairs at the model's resolution (free-form strokes over `hole`), cut into
pool / batch fixed batches used in a seeded order; `warmup_calls` before
the window; `trace_calls` traced after it with `--trace 1`.

End-to-end candidates: `img_per_s`, all images returned over the
window's time; `forward_ms`, the window's time over its calls (one
caller, so the mean latency from host input to host output).
"""

from __future__ import annotations

import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, List

import numpy as np
import torch

from .. import check, profiling, program
from . import images


@dataclass
class State:
    forward: Any
    batches: np.ndarray          # [pool / batch, batch, R, R, 4]
    order: np.ndarray
    weights: Any


@dataclass
class Window:
    calls: int
    images: int
    seconds: float
    host_s: List[float]          # forward call to its return, per call
    latency_s: List[float]       # host input to host output, per call
    sample: list = field(default_factory=list)   # (batch index, output)
    trace: Any = None
    attempted: int = 0
    failed: int = 0

    def e2e(self) -> dict:
        return {"img_per_s": self.images / self.seconds,
                "forward_ms": 1e3 * self.seconds / self.calls}


def setup(run) -> State:
    mix, res = run.mix, run.config["resolution"]
    pool = {}
    maker = threading.Thread(target=lambda: pool.setdefault(
        "x", images.closed_pool(run.seed, mix["pool"], res, *mix["hole"])))
    maker.start()
    t0 = time.perf_counter()
    path = program.write_weights(run)
    forward = program.load(run, path)
    t1 = time.perf_counter()
    maker.join()
    t2 = time.perf_counter()
    batches = pool["x"].reshape(-1, mix["batch"], res, res, 4)
    order = images.rng(run.seed, 4).permutation(len(batches))
    for i in range(mix["warmup_calls"]):
        forward(batches[order[i % len(order)]]).cpu()
    if run.device == "cuda":
        torch.cuda.synchronize()
    print(f"setup: weights and load_model {t1 - t0:.3f} s, then the pool "
          f"{t2 - t1:.3f} s more, warm-up {time.perf_counter() - t2:.3f} s",
          file=sys.stderr)
    return State(forward, batches, order, path)


def measure(run, st: State) -> Window:
    fwd, batches, order = st.forward, st.batches, st.order
    keep = run.limits["sample_calls"]
    g = images.rng(run.seed, 5)
    sample, host_s, latency_s = [], [], []
    start = time.perf_counter()
    deadline = start + run.seconds
    k = 0
    while True:
        b = order[k % len(order)]
        t0 = time.perf_counter()
        y = fwd(batches[b])
        t1 = time.perf_counter()
        y = y.cpu()
        t2 = time.perf_counter()
        host_s.append(t1 - t0)
        latency_s.append(t2 - t0)
        # reservoir sample of the window's calls, drawn from the seed
        j = k if k < keep else int(g.integers(0, k + 1))
        if j < keep:
            if j < len(sample):
                sample[j] = (b, y)
            else:
                sample.append((b, y))
        k += 1
        if t2 >= deadline:
            break
    win = Window(k, k * batches.shape[1], t2 - start, host_s, latency_s,
                 sample, attempted=k)
    if run.trace:
        from torch.profiler import record_function

        n = run.mix["trace_calls"]
        with profiling.stretch() as held:
            for i in range(n):
                with record_function("forward"):
                    y = fwd(batches[order[i % len(order)]])
                with record_function("d2h"):
                    y.cpu()
        win.trace = held["trace"]
        win.trace.units.update(calls=n, images=n * batches.shape[1])
    return win


def release(run, st: State) -> None:
    st.forward = None
    program.free()


def check_outputs(run, st: State, outputs) -> dict:
    """outputs: (batch index, [batch, R, R, 3] host tensor) pairs, held
    image by image against the reference on the same inputs."""
    state = program.read_weights(run, st.weights)
    refs = {}
    for b in sorted({b for b, _ in outputs}):
        refs[b] = program.reference_outputs(run, state, st.batches[b])
    pairs = []
    for b, y in outputs:
        y = np.asarray(y)
        if len(y) != len(refs[b]):       # rows missing: a misshapen answer
            return check.image_numbers([(y, np.stack(refs[b]))])
        pairs += zip(y, refs[b])
    return check.image_numbers(pairs)


def verify(run, st: State, win: Window) -> dict:
    return check_outputs(run, st, win.sample)


def control(run, st: State, win: Window) -> dict:
    """The reference in TF32 put in the program's place on the window's
    sampled inputs: the readings that the limits must fail."""
    state = program.read_weights(run, st.weights)
    outs = {b: np.stack(program.reference_outputs(run, state, st.batches[b],
                                                  tf32=True))
            for b, _ in win.sample}
    return check_outputs(run, st, [(b, outs[b]) for b, _ in win.sample])
