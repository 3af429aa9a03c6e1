"""The readings that a cell's correctness limits are set from, on the
chip, in one process: for each seed a short run of the program at the
cell's own size and load (the lower readings), and the control, the
reference in TF32 put in the program's place on the same inputs (the
upper readings).

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 \
        [--seconds 4]

Prints one JSON line per seed, then the largest program reading and the
smallest control reading of each number.
"""

from __future__ import annotations

import argparse
import json
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    args = p.parse_args(argv)

    from . import harness, program

    lower, upper = {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        run = harness.load_run(args.workload, seed, args.seconds, False)
        drv = harness.kind(run.mix["kind"])
        t0 = time.perf_counter()
        try:
            st = drv.setup(run)
            win = drv.measure(run, st)
            drv.release(run, st)
            prog = drv.verify(run, st, win)
            ctrl = drv.control(run, st, win)
        finally:
            run.close()
            program.free()
        for k, v in prog.items():
            lower[k] = max(lower.get(k, 0.0), v)
        for k, v in ctrl.items():
            upper[k] = min(upper.get(k, float("inf")), v)
        print(json.dumps({"seed": seed, "program": prog, "control": ctrl,
                          "failed": win.failed, "attempted": win.attempted,
                          "seconds": time.perf_counter() - t0}), flush=True)
    print(json.dumps({"workload": args.workload, "lower": lower,
                      "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
