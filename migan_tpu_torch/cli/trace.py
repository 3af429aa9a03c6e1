"""Where the device time of the kernel-path forward goes, on one GPU.

    python -m migan_tpu_torch.cli.trace [--model-name migan-512] \
        [--batch-size 8]

Makes seeded random weights with non-zero noise strengths, loads them
through the demo's `load_model` in float32, runs one forward to warm up
and then three forwards under `torch.profiler`. Prints the device time of
each kernel (the profiler's device-side events, summed by name) and the
device's busy share: the union of the device events' intervals inside the
profiled window, over the window's length. The window is a host-side
`record_function` span around the forwards and their final synchronize,
so it encloses all of their device work and the share cannot pass 100%.
Exits 1 when no CUDA device is present.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

import torch

WINDOW = "migan_trace_window"
FORWARDS = 3
ROWS = 15          # kernel names listed, by device time
SEED = 0


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def seeded_generator(resolution: int, seed: int):
    """`generator_init` weights of migan-<resolution> from `seed`, with
    random non-zero noise strengths (the init's zeros bypass the noise)."""
    from ..models.migan_inference import (
        GeneratorConfig, SeparableConv, generator_init,
    )

    gen = torch.Generator().manual_seed(seed)
    g = generator_init(GeneratorConfig(resolution=resolution), gen)
    with torch.no_grad():
        for m in g.modules():
            if isinstance(m, SeparableConv) and m.use_noise:
                m.noise_strength.copy_(torch.randn((), generator=gen) * .5)
    return g


def seeded_input(n: int, resolution: int, seed: int) -> torch.Tensor:
    """[n, res, res, 4] generator input on the CPU: mask - 0.5 and the
    masked image in [-1, 1]."""
    gen = torch.Generator().manual_seed(seed)
    img = torch.rand(n, resolution, resolution, 3, generator=gen) * 2 - 1
    mask = (torch.rand(n, resolution, resolution, 1, generator=gen)
            > 0.4).float()
    return torch.cat([mask - 0.5, img * mask], dim=-1)


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


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model-name", default="migan-512")
    p.add_argument("--batch-size", type=int, default=8)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = get_args(argv)
    if not torch.cuda.is_available():
        print("trace: no CUDA device", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from ..io import save_npz
    from .demo import load_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    res = int(args.model_name.split("-")[-1])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "w.npz")
        save_npz(path, seeded_generator(res, SEED))
        fwd, _ = load_model(args.model_name, path, "float32", "cuda")
    x = seeded_input(args.batch_size, res, SEED + 1).cuda()
    fwd(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            for _ in range(FORWARDS):
                fwd(x)
            torch.cuda.synchronize()

    events = prof.events()
    win = next(e for e in events
               if e.name == WINDOW and e.device_type == DeviceType.CPU)
    lo, hi = win.time_range.start, win.time_range.end
    # device work only: the window's own annotation may appear there too
    dev = [e for e in events
           if e.device_type == DeviceType.CUDA and e.name != WINDOW]
    if not dev:
        raise RuntimeError("the profiler recorded no device events")
    k = FORWARDS
    spans = [(e.time_range.start, e.time_range.end) for e in dev]
    busy = busy_union(spans, (lo, hi)) / k / 1e3
    summed = sum(e - s for s, e in spans) / k / 1e3
    wall = (hi - lo) / k / 1e3
    outside = sum(1 for s, e in spans if s < lo or e > hi)
    by_name: dict = {}
    for e in dev:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)

    gpu = card()
    print(f"trace {args.model_name} N={args.batch_size} float32 "
          f"kernel path, {k} forwards under torch.profiler; {gpu}")
    print(f"{'device ms/fwd':>13} {'events/fwd':>10} {'share':>6}  name")
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for name, (t, c) in rows[:ROWS]:
        print(f"{t / k / 1e3:13.3f} {c / k:10.1f} "
              f"{100 * t / k / 1e3 / summed:5.1f}%  {name[:100]}")
    rest = rows[ROWS:]
    print(f"{sum(t for _, (t, _) in rest) / k / 1e3:13.3f} "
          f"{sum(c for _, (_, c) in rest) / k:10.1f} "
          f"{'':>6}  ({len(rest)} other names)")
    print(f"device events summed {summed:.3f} ms/fwd; busy (union) "
          f"{busy:.3f} ms of {wall:.3f} ms window per forward = "
          f"{100 * busy / wall:.1f}% busy; {outside} of {len(spans)} "
          f"device events reach outside the window")
    return 0


if __name__ == "__main__":
    sys.exit(main())
