"""Open loop: the program's HTTP server (`cli/serve.py::make_server`, its
default mode) in this process, loaded at a fixed Poisson rate by the
sender (`traffic/sender.py`) in a process of its own.

Mix parameters: `rate` requests/s; `pool` distinct request bodies of the
`sizes` ([width, height] in turn) with `mask` holes ("stroke" or
"object") over `hole`, JPEG at `jpeg_quality`; `warmup` requests before
the window; `trace_seconds` traced from a third of the way in with
`--trace 1`. The bodies are made in the sender while this process loads
the program, both in set-up.

End-to-end candidates: `request_p95_ms`, the nearest-rank 95th
percentile of every request due in the window, each from its due time to
its reply (a failed one to when it failed), for a rate below what the
server sustains; `served_per_s`, the requests answered by the window's
close over its length, for a rate above it. The replies of a seeded
sample of requests, the largest image among them, are checked.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
from dataclasses import dataclass
from typing import Any, List

import numpy as np

from .. import check, profiling, program
from ..reference import serve as ref_serve
from . import images, schedule
from .sender import order

HOST = "127.0.0.1"


@dataclass
class State:
    server: Any
    batcher: Any
    thread: Any
    sender: Any
    start: float
    keep: List[int]
    weights: Any


@dataclass
class Window:
    seconds: float
    images: int                  # rows served in the window
    dispatches: int
    latency_s: List[float]
    attempted: int
    failed: int
    answered: int                # requests answered by the window's close
    trace: Any = None

    def e2e(self) -> dict:
        return {"request_p95_ms": 1e3 * schedule.nearest_rank(
                    self.latency_s, 0.95),
                "served_per_s": self.answered / self.seconds}


def sample(run) -> List[int]:
    """The requests whose replies are checked: a seeded sample of those
    due in the window, with the first request of the largest size."""
    mix = run.mix
    n = len(schedule.due_times(mix["rate"], run.seconds, run.seed))
    g = images.rng(run.seed, 7)
    keep = set(g.choice(n, min(run.limits["sample_requests"], n),
                        replace=False).tolist())
    perm = order(run.seed, mix)
    area = [w * h for w, h in (images.body_size(mix, perm[k % len(perm)])
                               for k in range(n))]
    keep.add(int(np.argmax(area)))
    return sorted(keep)


def _line(proc, prefix: str) -> str:
    while True:
        line = proc.stdout.readline()
        if not line:
            raise RuntimeError(f"the sender ended (exit {proc.wait()}) "
                               f"before printing {prefix!r}")
        if line.startswith(prefix):
            return line.strip()


def start_sender(run, keep: List[int]):
    spec = {"seed": run.seed, "mix": run.mix, "seconds": run.seconds,
            "keep": keep, "out": str(run.scratch()),
            "warmup": run.mix["warmup"]}
    return subprocess.Popen(
        [sys.executable, "-m", "portbench.traffic.sender", json.dumps(spec)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
        cwd=str(run.root))


def start_server(run):
    """(server, batcher, its thread, weights): `make_server` in its
    default mode on a free port, its batch buckets warmed up."""
    from torch.profiler import record_function

    from migan_tpu_torch.cli.serve import make_server

    path = program.write_weights(run)
    forward = program.load(run, path)

    def traced(x):
        with record_function("forward"):
            return forward(x)

    server, batcher = make_server(traced, run.config["resolution"], HOST, 0,
                                  run.config["model_name"])
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    batcher.warmup()
    return server, batcher, thread, path


def go(sender, server) -> float:
    """Hand the sender the server's address once its bodies are made;
    returns the window's start."""
    _line(sender, "ready")
    sender.stdin.write(f"go http://{HOST}:{server.server_address[1]}"
                       f"/inpaint\n")
    sender.stdin.flush()
    return float(_line(sender, "start").split()[1])


def setup(run) -> State:
    keep = sample(run)
    sender = start_sender(run, keep)
    try:
        server, batcher, thread, path = start_server(run)
        return State(server, batcher, thread, sender, go(sender, server),
                     keep, path)
    except BaseException:
        sender.kill()           # leave no process behind
        sender.wait()
        raise


def _served(batcher):
    sizes = list(batcher.batch_sizes_served)
    return len(sizes), sum(sizes)


def _sleep_until(t: float) -> None:
    time.sleep(max(0.0, t - time.perf_counter()))


def measure(run, st: State) -> Window:
    _sleep_until(st.start)
    d0, r0 = _served(st.batcher)
    trace = None
    if run.trace:
        _sleep_until(st.start + run.seconds / 3)
        t_end = time.perf_counter() + run.mix["trace_seconds"]
        s0 = _served(st.batcher)[0]
        with profiling.stretch() as held:
            _sleep_until(t_end)
        trace = held["trace"]
        trace.units["calls"] = _served(st.batcher)[0] - s0
    _sleep_until(st.start + run.seconds)
    d1, r1 = _served(st.batcher)
    res = json.loads(_line(st.sender, "{"))
    st.sender.wait()
    due, done, status = res["due"], res["done"], res["status"]
    end = run.seconds + 60.0
    lat = schedule.latencies(due, [end if t is None else t for t in done])
    failed = sum(1 for s in status if s != 200)
    answered = sum(1 for t, s in zip(done, status)
                   if s == 200 and t <= run.seconds)
    return Window(run.seconds, r1 - r0, d1 - d0, lat, len(due), failed,
                  answered, trace)


def release(run, st: State) -> None:
    st.server.shutdown()
    st.server.server_close()
    st.batcher.close()
    st.thread.join(timeout=10)
    if st.sender.poll() is None:
        st.sender.kill()
        st.sender.wait()
    program.free()


def _replies(run, st: State, control: bool) -> dict:
    """The kept requests' replies against the reference's on the same
    bodies: the served PNGs, or with `control` the reference's own
    replies with its generator in TF32 in the program's place."""
    state = program.read_weights(run, st.weights)
    perm = order(run.seed, run.mix)
    res = run.config["resolution"]
    decoded = [ref_serve.decode(images.body(run.seed, run.mix,
                                            perm[k % len(perm)]), res)
               for k in st.keep]
    xs = np.concatenate([d[0] for d in decoded])
    refs = program.reference_outputs(run, state, xs)
    if control:
        outs = program.reference_outputs(run, state, xs, tf32=True)
    pairs = []
    for i, (k, (_, img, mask)) in enumerate(zip(st.keep, decoded)):
        if control:
            got = ref_serve.reply(outs[i], img, mask)
        else:
            path = run.scratch() / f"{k}.png"
            got = (ref_serve.read_png(path.read_bytes()) if path.exists()
                   else None)
        pairs.append((got, ref_serve.reply(refs[i], img, mask)))
    return check.reply_numbers(pairs)


def verify(run, st: State, win: Window) -> dict:
    return _replies(run, st, control=False)


def control(run, st: State, win: Window) -> dict:
    """The readings that the limits must fail."""
    return _replies(run, st, control=True)
