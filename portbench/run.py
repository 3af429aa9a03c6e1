"""One run of one benchmark cell.

    python3 -m portbench.run --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

Makes the cell's inputs and weights from the seed, sets the program up
and warms up the cell's own shapes (all of it `setup_s`), measures for
`--seconds`, reads the peak device memory, frees the program, checks the
sampled outputs against the plain reference, and prints one JSON line
last on standard output: the cell's end-to-end metrics (`--trace 0`) or
its per-layer metrics read from a traced stretch (`--trace 1`), with
each number compared beside its limit under `check`, last. The same
comparison ends standard error. Exits 2 without a result when the
cell's cards are not there, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def execute(run, t0: float) -> dict:
    """Set up, measure, check: the result line as a dict."""
    import torch

    from . import check, harness, profiling, program
    from .readings import Reading
    from .reference import work

    drv = harness.kind(run.mix["kind"])
    cuda = run.device == "cuda"
    try:
        state = drv.setup(run)
        setup_s = time.perf_counter() - t0
        win = drv.measure(run, state)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        drv.release(run, state)
        numbers = drv.verify(run, state, win)
    finally:
        run.close()
    correct, rows = check.verdict(numbers, run.limits)
    correct &= win.failed == 0
    name = torch.cuda.get_device_name(0) if cuda else "cpu"
    device = {"platform": "gpu" if cuda else "cpu", "kind": name,
              "count": run.cell["chips"], "memory_peak_bytes": peak}
    metrics, breakdown = {}, None
    if not run.trace:
        values = dict(win.e2e(), setup_s=setup_s)
        for m in run.e2e:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        tr = win.trace
        device.update(busy_s=tr.busy_s(), window_s=tr.window_s)
        reading = Reading(run.config, win, tr, work.peaks(name))
        for m in run.per_layer:
            v = harness.reader(m["name"]).read(reading)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        breakdown = profiling.breakdown(tr)
    program.free()
    out = {"correct": bool(correct), "attempted": win.attempted,
           "failed": win.failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["check"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    return out


def main(argv=None) -> int:
    args = get_args(argv)
    import torch

    from . import harness

    run = harness.load_run(args.workload, args.seed, args.seconds,
                           bool(args.trace))
    chips = run.cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    card = harness.card_line()
    result = execute(run, T0)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 2
    print(f"card: {card}; peaks: reference/peaks.json", file=sys.stderr)
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
