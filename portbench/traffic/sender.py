"""The open-loop sender, a process of its own (standard library, numpy
and PIL; no torch), so that the clients' work does not take the server's
interpreter lock. Its request machinery follows the program's
`cli/loadgen.py`; its loop does not: requests go out on the schedule
whatever the server does, and each is timed from when it was due.

    python3 -m portbench.traffic.sender '<spec JSON>'

spec: seed, mix, seconds, keep (request indices whose replies are saved
to out/<k>.png), out, warmup (requests sent before the window).
Protocol on stdin / stdout: prints `ready` once the bodies are made,
reads `go <url>`, sends the warm-up requests, prints `start <t>` (the
window's start on the monotonic clock that `time.perf_counter` reads in
every process), sends the window's requests, waits for each reply up to
`GRACE_S` past the window's close, and prints one JSON line: each
request's due and done offsets from the start and its status. Its own
lateness goes to standard error before that.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

from . import images, schedule

GRACE_S = 60.0
LEAD_S = 0.05
WORKERS = 64                   # connections in flight at most
WARMUP_CONCURRENCY = 4


def order(seed: int, mix: dict):
    """Request k sends body order[k % pool]."""
    return images.rng(seed, 6).permutation(mix["pool"])


def post(url: str, body: bytes, timeout: float):
    req = urllib.request.Request(url, data=body, headers={
        "Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=max(timeout, 0.1)) as r:
        return r.status, r.read()


def main(argv=None) -> int:
    spec = json.loads((argv or sys.argv)[1])
    seed, mix, seconds = spec["seed"], spec["mix"], spec["seconds"]
    perm = order(seed, mix)
    with ThreadPoolExecutor(images.WORKERS) as pool:
        bodies = list(pool.map(lambda i: images.body(seed, mix, i),
                               range(mix["pool"])))
    print("ready", flush=True)
    url = sys.stdin.readline().split()[1]
    with ThreadPoolExecutor(WARMUP_CONCURRENCY) as pool:
        warm = list(pool.map(lambda k: post(url, bodies[perm[k % len(perm)]],
                                            120)[0],
                             range(spec["warmup"])))
    if any(s != 200 for s in warm):
        print(f"sender: warm-up statuses {warm}", file=sys.stderr)
        return 1

    due = schedule.due_times(mix["rate"], seconds, seed)
    n = len(due)
    keep = set(spec["keep"])
    sent, done, status = [None] * n, [None] * n, [0] * n
    close = None
    lock = threading.Lock()

    def send(k):
        t = time.perf_counter()
        sent[k] = t
        try:
            code, data = post(url, bodies[perm[k % len(perm)]],
                              close + GRACE_S - t)
        except Exception as e:  # refused, reset, timed out: failed
            code, data = -1, repr(e).encode()
        with lock:
            done[k], status[k] = time.perf_counter(), code
        if k in keep and code == 200:
            with open(os.path.join(spec["out"], f"{k}.png"), "wb") as f:
                f.write(data)

    start = time.perf_counter() + LEAD_S
    close = start + seconds
    print(f"start {start!r}", flush=True)
    pool = ThreadPoolExecutor(WORKERS)
    futures = []
    for k in range(n):
        wait = start + due[k] - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        futures.append(pool.submit(send, k))
    end_by = close + GRACE_S
    for f in futures:
        try:
            f.result(timeout=max(0.1, end_by - time.perf_counter() + 5))
        except Exception:       # never came: it stays failed
            pass
    pool.shutdown(wait=False, cancel_futures=True)
    late = sorted(s - (start + d) for s, d in zip(sent, due)
                  if s is not None) or [float("nan")]
    print(f"sender: {n} requests at {mix['rate']} /s; lateness ms p50 "
          f"{1e3 * schedule.nearest_rank(late, 0.5):.3f} p95 "
          f"{1e3 * schedule.nearest_rank(late, 0.95):.3f} max "
          f"{1e3 * late[-1]:.3f}", file=sys.stderr, flush=True)
    print(json.dumps({"due": [float(d) for d in due],
                      "done": [None if t is None else t - start
                               for t in done],
                      "status": status}), flush=True)
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)          # without waiting for a reply that never came
