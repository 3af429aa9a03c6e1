"""The highest rate a serve cell's server sustains, found once on the
chip by a sweep: one server, one sender per rate, each for `--seconds`.
A rate is sustained when every request was answered by the window's
close plus `--slack` and the 95th percentile stays under `--limit-ms`.

    python3 -m portbench.sweep --workload migan512.serve \
        --rates 20,30,40 --seconds 15 --limit-ms 1000

Prints one JSON line per rate.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=15.0)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--limit-ms", type=float, default=1000.0)
    p.add_argument("--slack", type=float, default=1.0)
    args = p.parse_args(argv)

    from . import harness
    from .traffic import open_loop, schedule

    run = harness.load_run(args.workload, args.seed, args.seconds, False)
    server, batcher, thread, path = open_loop.start_server(run)
    try:
        for rate in (float(r) for r in args.rates.split(",")):
            run.mix = dict(run.mix, rate=rate)
            sender = open_loop.start_sender(run, [])
            st = open_loop.State(server, batcher, thread, sender,
                                 open_loop.go(sender, server), [], path)
            win = open_loop.measure(run, st)
            in_time = sum(1 for lat, due in zip(
                win.latency_s, schedule.due_times(rate, args.seconds,
                                                  args.seed))
                          if due + lat <= args.seconds + args.slack)
            p95 = 1e3 * schedule.nearest_rank(win.latency_s, 0.95)
            print(json.dumps({
                "rate": rate, "attempted": win.attempted,
                "failed": win.failed, "answered_by_close": in_time,
                "p50_ms": 1e3 * schedule.nearest_rank(win.latency_s, 0.5),
                "p95_ms": p95, "mean_batch": win.images / max(
                    win.dispatches, 1),
                "sustained": in_time == win.attempted and win.failed == 0
                and p95 <= args.limit_ms}), flush=True)
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
        run.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
