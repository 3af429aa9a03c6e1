"""The generator's forward with the image's rows split over the ranks of
a `torch.distributed` group (`parallel/spatial.py`, the counterpart of
the JAX package's `spatial_sharding`), held against the one-process
forward and timed.

    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        -m migan_tpu_torch.cli.spatial --model-name migan-512 \
        --model-path w.npz --size 2048 --device cpu

Every rank loads the weights (`.npz` or `.pt`) and makes the same seeded
[1, size, size, 4] input (`cli/trace.py::seeded_input`), runs
`generator_apply_spatial` on its rows and `generator_apply` on the whole
image; the ranks' rows are gathered and held against the one-process
output within 1e-5 + 1e-5 |plain| (the JAX test's bound). Then both
forwards are timed in turns (plain, spatial, spatial, plain; CUDA events
on a card, the host clock on the CPU). Rank 0 prints one JSON line: the
world size, each rank's rows, the largest difference, ms per forward of
each turn, and on a card the peak memory allocated by each forward.
Exits 1 when the sharded output is out of bounds. Without the
launcher's env it runs as one process with no group. On a card float32
is IEEE float32 (TF32 off), as `load_model` sets it.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time

import torch

TOL = 1e-5
BATCH = 1
SEED = 7


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model-name", required=True, help="migan-<resolution>")
    p.add_argument("--model-path", required=True)
    p.add_argument("--size", type=int, required=True,
                   help="the input's height and width")
    p.add_argument("--reps", type=int, default=3,
                   help="timed forwards of each turn")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (NCCL, cuda:LOCAL_RANK) raises when no card "
                   "is present; 'cpu' (gloo)")
    return p.parse_args(argv)


def _time(fn, device: torch.device, reps: int) -> float:
    """ms per call of fn over `reps` calls."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def _peak_gib(fn, device: torch.device):
    """fn()'s result, and its peak memory allocated on a card (None on
    the CPU)."""
    if device.type != "cuda":
        return fn(), None
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    y = fn()
    torch.cuda.synchronize(device)
    return y, torch.cuda.max_memory_allocated(device) / 2 ** 30


def main(argv=None) -> dict:
    from .. import parallel
    from ..io import load_weights
    from ..models.migan_inference import GeneratorConfig, generator_apply
    from .trace import seeded_input

    args = get_args(argv)
    m = re.fullmatch(r"migan-(\d+)", args.model_name)
    if m is None:
        raise ValueError(f"Unsupported model name: {args.model_name}")
    device = parallel.maybe_initialize_distributed(args.device)
    try:
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"device {args.device!r} requested but "
                                   "no CUDA device is available")
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        print(parallel.describe(device), flush=True)
        g = load_weights(args.model_path, GeneratorConfig(
            resolution=int(m.group(1)))).to(device).eval()
        x = seeded_input(BATCH, args.size, SEED).to(device)
        x_local = parallel.shard_rows(x)
        fns = {"plain": lambda: generator_apply(g, x),
               "spatial": lambda: parallel.generator_apply_spatial(
                   g, x_local)}
        ys, peak = {}, {}
        for name, fn in fns.items():      # also the warm-up
            ys[name], peak[name] = _peak_gib(fn, device)
        y = parallel.gather_rows(ys["spatial"])
        ref = ys["plain"]
        diff = (y - ref).abs()
        out = {"world": parallel.world(), "rows": x_local.shape[1],
               "shape": list(y.shape), "finite": bool(torch.isfinite(y).all()),
               "max_abs_err": float(diff.max()),
               "excess": float((diff - TOL - TOL * ref.abs()).max())}
        del ys, y, ref, diff
        ms = {k: [] for k in fns}
        for name in ("plain", "spatial", "spatial", "plain"):
            parallel.barrier()
            ms[name].append(_time(fns[name], device, args.reps))
        out.update(ms=ms, peak_gib=peak if device.type == "cuda" else None,
                   device=(torch.cuda.get_device_name(device)
                           if device.type == "cuda" else "cpu"))
        if parallel.rank() == 0:
            print(json.dumps(out), flush=True)
        return out
    finally:
        parallel.destroy()


if __name__ == "__main__":
    r = main()
    sys.exit(0 if r["finite"] and r["excess"] <= 0 else 1)
