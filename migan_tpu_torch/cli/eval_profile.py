"""Evaluation's step split into its parts, on the port (port of
`scripts/bench_eval_profile.py`).

    python -m migan_tpu_torch.cli.eval_profile [bs]   # default 128, card

At migan-512, batch `bs`, times with CUDA events (2 warm-up calls, then
the mean of 8 timed calls, the device synchronized through a checksum of
the last output before the clock is read):
  - the full step of `cli/evaluate.py::score_batch` (generator, composite
    and clip, LPIPS, Inception on the real and the composite images), as
    `full_baseline`, and its variants: one Inception call over [real;
    composite] (`full_batched_det`), bf16 detectors (`full_bf16_det`)
    and both (`full_batched_bf16`), each in ms and images/s;
  - each part alone: the generator (`G_ms`), the composite and clip,
    the detector's 299 bilinear resize in float32 and bf16, Inception at
    N and 2N and LPIPS in float32 and bf16.

The generator is migan-512's kernel chain (`KernelGenerator`) in bf16 on
seeded random weights, as the JAX script runs the Pallas chain on bf16
params; the detectors are `evalx/inception.py` and `evalx/lpips.py` on
seeded random weights, with their `compute_dtype`. Inputs are zeros, as
there. Prints the dict as JSON and writes it to `eval_profile.json` in
the temp directory (`TMPDIR`, by default /tmp). The numbers are not
rounded; `device` names what they ran on.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import torch

# The JAX script's keys, in its order
FULL = (("full_baseline", False, None), ("full_batched_det", True, None),
        ("full_bf16_det", False, torch.bfloat16),
        ("full_batched_bf16", True, torch.bfloat16))
DET_DTYPES = ((None, "f32"), (torch.bfloat16, "bf16"))
KEYS = tuple(f"{n}_{u}" for n, _, _ in FULL for u in ("ms", "imgs_per_sec")) \
    + ("G_ms", "composite_ms", "resize_ms", "resize_bf16_ms") \
    + tuple(f"{p}_{t}_ms" for _, t in DET_DTYPES
            for p in ("inception", "inception2n", "lpips"))


def timeit(fn, *args, device: torch.device, warmup: int = 2,
           iters: int = 8) -> float:
    """Mean ms of fn(*args) over `iters` calls after `warmup`; the window
    ends at a checksum of the last output read back to the host. On the
    card CUDA events; on the CPU the host clock."""
    def checksum(y):
        return y.float().sum()

    for _ in range(warmup):
        float(checksum(fn(*args)))
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            y = fn(*args)
        c = checksum(y)
        end.record()
        float(c)
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        y = fn(*args)
    float(checksum(y))
    return (time.perf_counter() - t0) / iters * 1e3


@torch.no_grad()
def profile(bs: int, res: int = 512, iters: int = 8, warmup: int = 2,
            device="cuda") -> dict:
    """The JAX script's dict (`KEYS`, and `bs`) at batch `bs` and
    resolution `res`, on `device` (the CPU takes the kernels' plain
    versions); `device` is added, the card's name or "cpu"."""
    from ..evalx.inception import inception_apply, inception_init
    from ..evalx.lpips import lpips_init
    from ..models.migan_inference import GeneratorConfig, generator_init
    from ..models.migan_kernels import KernelGenerator
    from ..ops.resize import resize_bilinear

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA "
                           "device is available")
    g = generator_init(GeneratorConfig(resolution=res),
                       torch.Generator().manual_seed(0))
    chain = KernelGenerator(g.to(device=dev, dtype=torch.bfloat16).eval())
    inc = inception_init(1).to(dev)
    lp = lpips_init(2).to(dev)

    x = torch.zeros(bs, res, res, 4, dtype=torch.bfloat16, device=dev)
    imgs = torch.zeros(bs, res, res, 3, device=dev)
    masks = torch.ones(bs, res, res, 1, device=dev)
    img01 = torch.zeros(bs, res, res, 3, device=dev)
    img01_2n = torch.zeros(2 * bs, res, res, 3, device=dev)

    def t(fn, *args):
        return timeit(fn, *args, device=dev, warmup=warmup, iters=iters)

    def full(batched_det, det_dtype):
        def step(x, imgs, masks):
            o = chain(x).float()
            composed = masks * imgs + (1 - masks) * o
            i01 = (imgs * 0.5 + 0.5).clamp(0, 1)
            c01 = (composed * 0.5 + 0.5).clamp(0, 1)
            lpd = lp(i01, c01, normalize=True, compute_dtype=det_dtype)
            if batched_det:
                acts = inception_apply(inc, torch.cat([i01, c01]),
                                       compute_dtype=det_dtype)
                ra, fa = acts[:bs], acts[bs:]
            else:
                ra = inception_apply(inc, i01, compute_dtype=det_dtype)
                fa = inception_apply(inc, c01, compute_dtype=det_dtype)
            return lpd.sum() + ra.float().sum() + fa.float().sum()
        return step

    out = {"bs": bs, "device": (torch.cuda.get_device_name(dev)
                                if dev.type == "cuda" else "cpu")}
    for name, batched, dt in FULL:
        ms = t(full(batched, dt), x, imgs, masks)
        out[name + "_ms"] = ms
        out[name + "_imgs_per_sec"] = bs / ms * 1e3
        print(name, ms, "ms", out[name + "_imgs_per_sec"], "img/s",
              flush=True)
    out["G_ms"] = t(lambda x: chain(x).float().sum(), x)
    out["composite_ms"] = t(
        lambda o, imgs, masks: ((masks * imgs + (1 - masks) * o) * 0.5
                                + 0.5).clamp(0, 1), imgs, imgs, masks)
    out["resize_ms"] = t(
        lambda v: resize_bilinear(v, (299, 299), antialias=True), img01)
    out["resize_bf16_ms"] = t(
        lambda v: resize_bilinear(v.to(torch.bfloat16), (299, 299),
                                  antialias=True), img01)
    for dt, tag in DET_DTYPES:
        out[f"inception_{tag}_ms"] = t(
            lambda v: inception_apply(inc, v, compute_dtype=dt), img01)
        out[f"inception2n_{tag}_ms"] = t(
            lambda v: inception_apply(inc, v, compute_dtype=dt), img01_2n)
        out[f"lpips_{tag}_ms"] = t(
            lambda a, b: lp(a, b, normalize=True, compute_dtype=dt),
            img01, img01)
    return out


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    bs = int(argv[0]) if argv else 128
    out = profile(bs)
    print(json.dumps(out, indent=1), flush=True)
    with open(os.path.join(tempfile.gettempdir(), "eval_profile.json"),
              "wt") as f:
        json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
