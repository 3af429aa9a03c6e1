"""Closed-loop load generator for the serving CLI's ``POST /inpaint``
(`cli/serve.py`; the JAX package's server speaks the same protocol).

    python -m migan_tpu_torch.cli.loadgen \
        --url http://127.0.0.1:8080/inpaint --bodies requests.jsonl \
        --concurrency 16 --warmup 32 --requests 128 --repeats 3

`--bodies` holds one JSON request body per line; they are sent in turn,
over and over. Each of the `--concurrency` client threads sends its next
request as soon as it has read the reply to its last one, so the server
always has that many requests in flight and latency includes the wait
behind the others. Replies are counted in the order they complete:

  - the first `--warmup` replies are not measured;
  - the next `--repeats` windows of `--requests` replies are;
  - the last `--concurrency` replies are not, so that every measured reply
    completes while all clients are busy.

Per window: requests/s (its replies over the time from the previous
window's last reply to its own last), and latency p50 / p99 in ms (client
clock, from sending the request to having read the reply; nearest rank;
p99 only where the window holds at least 100 replies, else null).

Standard library only, so it starts fast, and it runs in a process of its
own, so that the clients' work does not take the server's interpreter
lock. Prints one JSON line; exits 1 if any request failed.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import threading
import time
import urllib.request

MIN_P99_SAMPLES = 100
REQUEST_TIMEOUT_S = 300.0


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--url", required=True)
    p.add_argument("--bodies", required=True,
                   help="file of JSON request bodies, one per line")
    p.add_argument("--concurrency", type=int, default=16)
    p.add_argument("--warmup", type=int, default=32)
    p.add_argument("--requests", type=int, default=128,
                   help="replies per measured window")
    p.add_argument("--repeats", type=int, default=3)
    return p.parse_args(argv)


def _rank(sorted_vals, q: float) -> float:
    """Nearest-rank percentile q in (0, 1] of an ascending list."""
    return sorted_vals[max(0, math.ceil(q * len(sorted_vals)) - 1)]


def run(url: str, bodies, concurrency: int, warmup: int, requests: int,
        repeats: int) -> dict:
    total = warmup + requests * repeats + concurrency
    lock = threading.Lock()
    sent = [0]
    done, errors = [], []   # done: (completion time, latency s)

    def client():
        while True:
            with lock:
                i = sent[0]
                if i >= total:
                    return
                sent[0] += 1
            req = urllib.request.Request(
                url, data=bodies[i % len(bodies)],
                headers={"Content-Type": "application/json"})
            t0 = time.perf_counter()
            try:
                with urllib.request.urlopen(req,
                                            timeout=REQUEST_TIMEOUT_S) as resp:
                    resp.read()
            except Exception as e:
                with lock:
                    errors.append(f"request {i}: {type(e).__name__}: {e}")
                continue
            t1 = time.perf_counter()
            with lock:
                done.append((t1, t1 - t0))

    threads = [threading.Thread(target=client) for _ in range(concurrency)]
    start = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    done.sort()
    windows = []
    if not errors:
        last = done[warmup - 1][0] if warmup else start
        for r in range(repeats):
            chunk = done[warmup + r * requests:warmup + (r + 1) * requests]
            ms = sorted(1e3 * lat for _, lat in chunk)
            seconds = chunk[-1][0] - last
            last = chunk[-1][0]
            windows.append({
                "requests": len(chunk), "seconds": seconds,
                "requests_per_s": len(chunk) / seconds,
                "p50_ms": _rank(ms, 0.5),
                "p99_ms": (_rank(ms, 0.99) if len(ms) >= MIN_P99_SAMPLES
                           else None)})
    return {"concurrency": concurrency, "sent": total,
            "errors": errors[:10], "n_errors": len(errors),
            "windows": windows}


def main(argv=None) -> int:
    args = get_args(argv)
    with open(args.bodies, "rb") as f:
        bodies = [line.rstrip(b"\n") for line in f if line.strip()]
    result = run(args.url, bodies, args.concurrency, args.warmup,
                 args.requests, args.repeats)
    print(json.dumps(result), flush=True)
    return 1 if result["n_errors"] else 0


if __name__ == "__main__":
    sys.exit(main())
