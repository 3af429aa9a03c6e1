#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`migan_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Builds the kernels from `migan_tpu_torch/csrc/` and then:

  1. runs each kernel against its plain PyTorch version on the card at
     migan-512's shapes (batch 2; the top level, C = 64, and a C = 512
     level), in float32 with TF32 off and in bfloat16; then times every
     kernel against its plain version at every shape a migan-512 forward
     launches it at, at N = 1 and N = 8 in both dtypes, holding each
     result against the plain one, and prints each shape's bound: the
     larger of its bytes (inputs read once, outputs written once) over
     3.35 TB/s and its pointwise product over the tensor cores' peak;
  2. writes seeded random migan-512 / migan-256 weights (non-zero noise
     strengths) with `save_npz`, loads them through the demo's
     `load_model`, runs the kernel chain at N = 1 and N = 8 (migan-256 at
     N = 8) in float32 and migan-512 at N = 8 in bfloat16, holds each
     against the plain generator on the same card, and checks that every
     forward launched 19 (migan-512) or 15 (migan-256) kernels;
  3. runs the demo CLI (`migan_tpu_torch.cli.demo`, `--device cuda`) on
     seeded PNG image/mask pairs, per image and batched, and checks that
     every composite was written at the right size, that the two runs
     agree, and that the kernels were launched 19 times per forward;
  4. times the kernel path and the plain path (median of 20 forwards
     after warm-up, in turns), float32 and, for migan-512, bfloat16;
  5. serves migan-512 (`migan_tpu_torch.cli.serve.make_server`, on
     127.0.0.1, max batch 8, warmed up) in resize mode (16 seeded PNGs
     at once, each reply within 1 uint8 of the direct program: the same
     pre-processing, `load_model` at N = 1, `postprocess`) and in pipeline
     mode (buckets 512,1024; 8 requests at once, up to 1024x768 and one
     oversize, each within 1 uint8 of `make_pipeline` at the same bucket
     padding, pixels outside the box unchanged); then puts each mode under
     sustained load from `python -m migan_tpu_torch.cli.loadgen` in a
     process of its own (16 and 8 clients in a closed loop, 32 replies of
     warm-up, 3 windows of 128 and 100 replies) and prints each window's
     requests/s and p50/p99 latency, and in resize mode the most of the
     time the device can have been busy (the forwards' host-clock time
     per request against the windows'); checks for every run that the
     clients were batched and that the kernels launched 19 times per
     dispatch; times one request's stages in order on one thread;
  6. runs the evaluation CLI (`migan_tpu_torch.cli.evaluate.main`,
     `--device cuda`) on 392 seeded 512² PNGs with on-the-fly masks and
     seeded detector .pth files, holds its per-image LPIPS and Inception
     activations against the same CLI on the CPU (first 4 items, the
     plain versions), runs it again with bfloat16 detectors and holds
     that within the bf16 bound; prints img/s and the share of the loop
     spent waiting for the loader in 3 windows of 128 images for both
     dtypes, and one batch's device work timed alone beside the loop's
     time per batch.

Where the device time of a forward goes is measured apart from this, by
`python -m migan_tpu_torch.cli.trace`.

It imports nothing of JAX and nothing of `migan_tpu`.

Prints the card's name and power limit, a JSON line of per-kernel
results, and as the last line {"ok": true, "device": {...}}. Any failure
raises and exits non-zero. Exits 1 without a result when no CUDA device
is present.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import tempfile
import time

import torch

SEED = 0

# Kernel vs its plain version on the card: |kernel - plain| <=
# ATOL + RTOL * |plain|. float32 (TF32 off) differs only in summation
# order; in bfloat16 the kernel keeps its intermediates in f32 where the
# plain path rounds after each of its ~6 ops (bf16 keeps 8 bits).
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (5e-2, 2e-2)}
# The clamp case (float32 only) has partial sums in the hundreds, so
# sum-order differences reach ~3e-4 where outputs cancel to near zero.
CLAMP_ATOL = 1e-3
# Kernel chain vs plain generator, float32: ~50 layers of clamp-256
# activations (the tolerance of tests/test_migan_inference.py).
GEN_ATOL, GEN_RTOL = 2e-3, 1e-3
# bfloat16 chain: its relative L2 distance from the float32 plain output
# may be at most BF16_FACTOR times the plain bfloat16 path's own. Both
# round to 8 bits at every layer, in other places, so neither matches
# float32 elementwise; the kernel chain must not lose more than the plain
# path does.
BF16_FACTOR = 2.0
# Evaluation on the card against the CPU (phase 6): the float32 kernel
# chain is within ~1e-5 of the plain generator, and cuDNN (TF32 off) and
# the CPU differ in summation order only, so per-image LPIPS may differ by
# EVAL_LPIPS_ATOL and an image's Inception activations by EVAL_ACTS_RTOL
# in relative L2.
EVAL_LPIPS_ATOL, EVAL_ACTS_RTOL = 1e-4, 1e-3
# bf16 detectors against float32 (tests/test_evalx.py's bounds): LPIPS
# relative error, Inception feature relative L2.
BF16_LPIPS_RTOL, BF16_ACTS_RTOL = 2e-3, 3e-2
EXPECTED_LAUNCHES = {512: {"sepconv": 9, "downblock": 5, "upblock": 5},
                     256: {"sepconv": 7, "downblock": 4, "upblock": 4}}
SOURCES = {
    "sepconv": ("migan_tpu_torch/csrc/sepconv.cu",
                "migan_tpu/ops/pallas/sepconv.py:250; "
                "migan_tpu/ops/pallas/packedblock.py:163"),
    "downblock": ("migan_tpu_torch/csrc/downblock.cu",
                  "migan_tpu/ops/pallas/downblock.py:170"),
    "upblock": ("migan_tpu_torch/csrc/upblock.cu",
                "migan_tpu/ops/pallas/upblock.py:303"),
}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# The card's peaks for a shape's bound (NVIDIA's H100 SXM data sheet):
# device memory, and the pointwise product on the tensor cores, bf16, or
# float32 as the kernels run it: three TF32 products at the TF32 peak.
HBM_BYTES_PER_S = 3.35e12
PRODUCT_FLOPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 495e12 / 3}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms over `reps` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def tolerance(dtype, what: str):
    """(atol, rtol) of a kernel-vs-plain check."""
    atol, rtol = TOL[dtype]
    return (CLAMP_ATOL if "clamp" in what else atol), rtol


def bound(inputs, outputs, product_flops: int, dtype):
    """(bound_ms, bound_by): the least time of one call, the larger of
    its bytes (each input read once, each output written once) over the
    memory rate and its pointwise product over the tensor cores' peak."""
    nbytes = sum(t.numel() * t.element_size() for t in (*inputs, *outputs))
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = product_flops / PRODUCT_FLOPS_PER_S[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def record_path(results: dict, path: str, counts: dict) -> None:
    """Keep one path's launch counts (driven from counts of 0) beside
    each kernel's row."""
    for k, v in counts.items():
        results[k].setdefault("launches_by_path", {})[path] = v


def max_err(a, b, dtype, what: str) -> float:
    a, b = a.float(), b.float()
    check(bool(torch.isfinite(a).all()), f"{what}: non-finite output")
    atol, rtol = tolerance(dtype, what)
    if "clamp" in what:
        check(bool((b.abs() == 256).any()), f"{what}: clamp never fired")
    err = (a - b).abs()
    bad = (err > atol + rtol * b.abs()).sum().item()
    check(bad == 0, f"{what}: {bad} elements beyond atol {atol} rtol {rtol} "
          f"(max |diff| {err.max().item():.3e})")
    return err.max().item()


# ---------------------------------------------------------------------------
# Phase 1: each kernel against its plain version
# ---------------------------------------------------------------------------

def kernel_cases(n: int, dtype, gen: torch.Generator):
    """(kernel, label, kernel call, plain call) at migan-512's shapes."""
    from migan_tpu_torch.ops.kernels import downblock, sepconv, upblock

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to("cuda", dtype)

    def sep_w(c, o):
        return r(3, 3, c, scale=1 / 3), r(c, scale=1 / 3), r(c, o,
                                                            scale=c ** -.5)

    cases = []
    # encoder top conv1 (C = 64), and a synthesis conv1 low half (C = 512)
    for (h, c, o, fa) in ((512, 64, 64, True), (32, 512, 512, False)):
        x = r(n, h, h, c)
        w = sep_w(c, o)
        cases.append(("sepconv", f"[{n},{h},{h},{c}]->{o} final_act={fa}",
                      lambda x=x, w=w, fa=fa: sepconv.fused_block(
                          x, *w, final_act=fa),
                      lambda x=x, w=w, fa=fa: sepconv.sepconv_plain(
                          x, *w, final_act=fa)))
    if dtype == torch.float32:
        # scaled input: the +-256 clamp of both activations fires
        x = r(n, 64, 64, 64, scale=400.)
        w = sep_w(64, 64)
        cases.append(("sepconv", f"[{n},64,64,64]->64 clamp",
                      lambda x=x, w=w: sepconv.fused_block(x, *w),
                      lambda x=x, w=w: sepconv.sepconv_plain(x, *w)))
    # encoder conv2 at 512 (C = 64 -> 128) and at 32 (C = 512 -> 512)
    for (h, c, o) in ((512, 64, 128), (32, 512, 512)):
        x = r(n, h, h, c)
        w = sep_w(c, o)
        cases.append(("downblock", f"[{n},{h},{h},{c}]->{o}",
                      lambda x=x, w=w: downblock.fused_down_block(x, *w),
                      lambda x=x, w=w: downblock.downblock_plain(x, *w)))
    # synthesis top level (rgb only) and the level at 64 (C = 512)
    for (h, c, o, emit) in ((512, 64, 64, False), (64, 512, 512, True)):
        args = (r(n, h // 2, h // 2, c), r(n, h, h, c), r(h, h, scale=.3),
                *sep_w(c, o), r(h, h, scale=.3), r(o, 3, scale=o ** -.5),
                r(3, scale=.1))
        cases.append(("upblock", f"[{n},{h // 2},{h // 2},{c}]->{o} "
                      f"emit_features={emit}",
                      lambda a=args, e=emit: upblock.fused_up_block(
                          *a, emit_features=e),
                      lambda a=args, e=emit: upblock.upblock_plain(
                          *a, emit_features=e)))
    return cases


def phase_kernels(results: dict) -> None:
    gen = torch.Generator().manual_seed(SEED)
    for dtype in (torch.float32, torch.bfloat16):
        for name, label, fk, fp in kernel_cases(2, dtype, gen):
            got, want = fk(), fp()
            torch.cuda.synchronize()
            if isinstance(got, tuple):
                errs = [max_err(a, b, dtype, f"{name} {label}")
                        for a, b in zip(got, want)]
            else:
                errs = [max_err(got, want, dtype, f"{name} {label}")]
            err = max(errs)
            atol, rtol = tolerance(dtype, label)
            print(f"phase1 {name} {label} {str(dtype)[6:]}: max|diff| "
                  f"{err:.3e} (atol {atol}, rtol {rtol})",
                  flush=True)
            if dtype == torch.float32:
                results[name]["max_abs_err"] = max(
                    results[name]["max_abs_err"], err)
    # times at every main-path shape, N = 1 and 8, both dtypes
    for dtype in (torch.float32, torch.bfloat16):
        for n in (1, 8):
            for name, label, fk, fp, args, flops in timed_cases(n, dtype):
                ms, plain_ms = cuda_ms(fk), cuda_ms(fp)
                got, want = fk(), fp()
                torch.cuda.synchronize()
                outs = got if isinstance(got, tuple) else (got,)
                wants = want if isinstance(want, tuple) else (want,)
                err = max(max_err(a, b, dtype, f"{name} {label}")
                          for a, b in zip(outs, wants))
                bound_ms, bound_by = bound(args, outs, flops, dtype)
                dt = str(dtype)[6:]
                print(f"phase1 time {name} {label} {dt}: kernel {ms:.4f} "
                      f"ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} "
                      f"ms ({bound_by}), plain/kernel {plain_ms / ms:.2f}x, "
                      f"bound/kernel {bound_ms / ms:.3f}, max|diff| "
                      f"{err:.3e}", flush=True)
                row = {"shape": label, "dtype": dt, "ms": ms,
                       "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "max_abs_err": err}
                results[name]["shapes"].append(row)
                if dtype == torch.float32:
                    results[name]["max_abs_err"] = max(
                        results[name]["max_abs_err"], err)
                    # the kernel's headline: float32, N = 8, the shape
                    # with the most work (largest bound), its top level
                    if n == 8 and row["bound_ms"] > results[name].get(
                            "bound_ms", 0.0):
                        for k in ("ms", "plain_ms", "bound_ms", "bound_by"):
                            results[name][k] = row[k]


def timed_cases(n: int, dtype):
    """(kernel, label, kernel call, plain call, input tensors, flops of the
    pointwise product) at every shape of a migan-512 forward, in call
    order; upblock as the forward calls it (rgb only at the top level).
    Inputs are made on the card."""
    from migan_tpu_torch.models.migan_inference import GeneratorConfig
    from migan_tpu_torch.models.migan_kernels import kernel_shapes
    from migan_tpu_torch.ops.kernels import downblock, sepconv, upblock

    gen = torch.Generator("cuda").manual_seed(SEED + n)

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * scale).to(dtype)

    cfg = GeneratorConfig(resolution=512)
    top = cfg.encode_res[0]
    seen, cases = set(), []
    for shape in kernel_shapes(cfg):
        name, h, w, c, o, fa = shape
        if shape in seen:
            continue
        seen.add(shape)
        sep = (r(3, 3, c, scale=1 / 3), r(c, scale=1 / 3),
               r(c, o, scale=c ** -.5))
        if name == "sepconv":
            args = (r(n, h, w, c), *sep)
            cases.append((name, f"[{n},{h},{w},{c}]->{o} final_act={fa}",
                          lambda a=args, fa=fa: sepconv.fused_block(
                              *a, final_act=fa),
                          lambda a=args, fa=fa: sepconv.sepconv_plain(
                              *a, final_act=fa), args, 2 * n * h * w * c * o))
        elif name == "downblock":
            args = (r(n, h, w, c), *sep)
            cases.append((name, f"[{n},{h},{w},{c}]->{o}",
                          lambda a=args: downblock.fused_down_block(*a),
                          lambda a=args: downblock.downblock_plain(*a),
                          args, 2 * n * (h // 2) * (w // 2) * c * o))
        else:
            emit = 2 * h != top
            args = (r(n, h, w, c), r(n, 2 * h, 2 * w, c),
                    r(2 * h, 2 * w, scale=.3), *sep,
                    r(2 * h, 2 * w, scale=.3), r(o, 3, scale=o ** -.5),
                    r(3, scale=.1))
            cases.append((name, f"x_lo [{n},{h},{w},{c}]->{o} "
                          f"{'feat+rgb' if emit else 'rgb only'}",
                          lambda a=args, e=emit: upblock.fused_up_block(
                              *a, emit_features=e),
                          lambda a=args, e=emit: upblock.upblock_plain(
                              *a, emit_features=e),
                          args, 2 * n * 4 * h * w * c * o))
    return cases


# ---------------------------------------------------------------------------
# Phase 2: the generator through load_model, against the plain generator
# ---------------------------------------------------------------------------

def make_weights(res: int, path: str) -> None:
    from migan_tpu_torch.cli.trace import seeded_generator
    from migan_tpu_torch.io import save_npz

    save_npz(path, seeded_generator(res, SEED + res))


def model_input(n: int, res: int) -> torch.Tensor:
    from migan_tpu_torch.cli.trace import seeded_input

    return seeded_input(n, res, SEED + 1).cuda()


def relative_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm()).item()


def phase_generator(tmp: str, results: dict) -> dict:
    """Returns {(res, dtype): (kernel forward, plain forward)} for phase
    3; both forwards take a float32 input and return float32."""
    from migan_tpu_torch.cli.demo import load_model
    from migan_tpu_torch.io import load_npz
    from migan_tpu_torch.models.migan_inference import generator_apply
    from migan_tpu_torch.ops.kernels import (
        launch_counts, reset_launch_counts,
    )

    forwards = {}
    for res, dtype in ((512, "float32"), (256, "float32"),
                       (512, "bfloat16")):
        path = os.path.join(tmp, f"migan{res}.npz")
        if not os.path.exists(path):
            make_weights(res, path)
        fwd, r = load_model(f"migan-{res}", path, dtype, "cuda")
        check(r == res, f"load_model resolution {r} != {res}")
        dt = DTYPES[dtype]
        plain_g = load_npz(path).to("cuda", dt).eval()
        forwards[res, dtype] = (fwd, lambda x, g=plain_g, dt=dt:
                                generator_apply(g, x.to(dt)).float())
    runs = [(512, 1, "float32"), (512, 8, "float32"), (256, 8, "float32"),
            (512, 8, "bfloat16")]

    # The main path's run: counts from 0, kernel forwards only.
    outs = []
    reset_launch_counts()
    for res, n, dtype in runs:
        before = launch_counts()
        y = forwards[res, dtype][0](model_input(n, res))
        torch.cuda.synchronize()
        after = launch_counts()
        per = {k: after[k] - before[k] for k in after}
        check(per == EXPECTED_LAUNCHES[res],
              f"migan-{res} N={n} {dtype}: launches {per}, expected "
              f"{EXPECTED_LAUNCHES[res]}")
        outs.append(y)
    totals = launch_counts()
    for k, v in totals.items():
        results[k]["launches"] = v
    record_path(results, "generator", totals)

    for (res, n, dtype), y in zip(runs, outs):
        x = model_input(n, res)
        what = f"migan-{res} N={n} {dtype}"
        check(tuple(y.shape) == (n, res, res, 3), f"shape {tuple(y.shape)}")
        check(bool(torch.isfinite(y).all()), f"{what}: non-finite")
        want = forwards[res, "float32"][1](x)
        if dtype == "float32":
            err = (y - want).abs()
            ok = bool((err <= GEN_ATOL + GEN_RTOL * want.abs()).all())
            print(f"phase2 {what}: kernel chain vs plain max|diff| "
                  f"{err.max().item():.3e} (|plain| max "
                  f"{want.abs().max().item():.3f}; atol {GEN_ATOL}, rtol "
                  f"{GEN_RTOL}) launches {EXPECTED_LAUNCHES[res]}",
                  flush=True)
            check(ok, f"{what}: kernel chain disagrees with plain")
            continue
        plain_bf16 = forwards[res, dtype][1](x)
        torch.cuda.synchronize()
        err, ref = relative_l2(y, want), relative_l2(plain_bf16, want)
        print(f"phase2 {what}: relative L2 to the float32 plain output: "
              f"kernel chain {err:.4e}, plain bfloat16 path {ref:.4e} "
              f"(limit {BF16_FACTOR} x plain; max|diff| kernel "
              f"{(y - want).abs().max().item():.3e}, plain "
              f"{(plain_bf16 - want).abs().max().item():.3e}) launches "
              f"{EXPECTED_LAUNCHES[res]}", flush=True)
        check(err <= BF16_FACTOR * ref,
              f"{what}: kernel chain {err:.4e} from float32, beyond "
              f"{BF16_FACTOR} x the plain path's {ref:.4e}")
    print(f"phase2 main-path launches {totals}", flush=True)
    return forwards


# ---------------------------------------------------------------------------
# Phase 3: the demo CLI on the card
# ---------------------------------------------------------------------------

DEMO_SIZES = ((512, 512), (640, 480), (300, 700))   # (w, h) of the images


def phase_demo(tmp: str, results: dict) -> None:
    """The demo's `main`, as `python -m migan_tpu_torch.cli.demo ...
    --device cuda` runs it, on seeded PNGs with the migan-512 weights of
    phase 2: per image (--batch-size 1) and batched (3, one forward)."""
    import numpy as np
    from PIL import Image

    from migan_tpu_torch.cli import demo
    from migan_tpu_torch.ops.kernels import (
        launch_counts, reset_launch_counts,
    )

    images, masks = os.path.join(tmp, "images"), os.path.join(tmp, "masks")
    os.makedirs(images)
    os.makedirs(masks)
    rng = np.random.RandomState(SEED)
    for i, (w, h) in enumerate(DEMO_SIZES):
        Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8)).save(
            os.path.join(images, f"{i}.png"))
        m = np.full((h, w), 255, np.uint8)
        m[h // 4:h // 2, w // 5:w // 2] = 0
        Image.fromarray(m).save(os.path.join(masks, f"{i}.png"))
    outs = {}
    for bs, forwards in (("1", len(DEMO_SIZES)), ("3", 1)):
        out = os.path.join(tmp, f"demo_bs{bs}")
        reset_launch_counts()
        t0 = time.perf_counter()
        demo.main(["--model-name", "migan-512", "--model-path",
                   os.path.join(tmp, "migan512.npz"), "--images-dir", images,
                   "--masks-dir", masks, "--output-dir", out, "--device",
                   "cuda", "--batch-size", bs, "--io-workers", "2"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = launch_counts()
        record_path(results, f"demo --batch-size {bs}", counts)
        want = {k: v * forwards for k, v in EXPECTED_LAUNCHES[512].items()}
        check(counts == want, f"demo --batch-size {bs}: launches {counts}, "
              f"expected {want}")
        for i, (w, h) in enumerate(DEMO_SIZES):
            path = os.path.join(out, f"{i}.png")
            check(os.path.exists(path), f"demo wrote no {path}")
            got = np.asarray(Image.open(path).convert("RGB"))
            scale = min(1.0, 512 / max(w, h))
            size = (int(h * scale), int(w * scale))
            check(got.shape == (*size, 3), f"demo {path}: shape {got.shape}")
            outs.setdefault(i, []).append(got.astype(np.int32))
        print(f"phase3 demo --batch-size {bs}: {len(DEMO_SIZES)} images "
              f"written in {dt:.2f} s, launches {counts}", flush=True)
    for i, (a, b) in outs.items():
        d = int(np.abs(a - b).max())
        check(d <= 1, f"demo image {i}: batched differs by {d} uint8")
    print("phase3 demo: per-image and batched composites within 1 uint8",
          flush=True)


# ---------------------------------------------------------------------------
# Phase 4: forward times
# ---------------------------------------------------------------------------

def phase_times(forwards: dict, gpu: str) -> None:
    for res, n, dtype in ((512, 1, "float32"), (512, 8, "float32"),
                          (256, 8, "float32"), (512, 1, "bfloat16"),
                          (512, 8, "bfloat16")):
        x = model_input(n, res)
        fwd, plain = forwards[res, dtype]
        times = {"kernel": [], "plain": []}
        for _ in range(3):
            fwd(x), plain(x)
        torch.cuda.synchronize()
        for i in range(20):
            order = (("kernel", fwd), ("plain", plain))
            for label, f in (order if i % 2 == 0 else order[::-1]):
                t0 = time.perf_counter()
                f(x)
                torch.cuda.synchronize()
                times[label].append(time.perf_counter() - t0)
        for label in ("kernel", "plain"):
            med = statistics.median(times[label])
            print(f"phase4 migan-{res} N={n} {dtype} {label} path: "
                  f"{med * 1e3:.3f} ms/forward, {n / med:.2f} img/s "
                  f"(median of 20; {gpu})", flush=True)


# ---------------------------------------------------------------------------
# Phase 5: the HTTP service on the card
# ---------------------------------------------------------------------------

# (w, h) of the pipeline-mode requests: both buckets and one oversize
PIPELINE_SIZES = ((512, 512), (1024, 768), (640, 480), (300, 700),
                  (800, 600), (768, 512), (1000, 750), (1300, 800))
# Sustained load (`migan_tpu_torch.cli.loadgen`, a process of its own):
# clients in a closed loop, LOAD_WARMUP replies unmeasured, then
# LOAD_REPEATS windows of at least 100 replies each (a p99 needs 100).
LOAD_WARMUP, LOAD_REPEATS = 32, 3
LOAD = {"serve resize": (16, 128), "serve pipeline": (8, 100)}


def _png_bytes(arr) -> bytes:
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _png_b64(arr) -> str:
    import base64

    return base64.b64encode(_png_bytes(arr)).decode()


def _request(seed: int, w: int, h: int):
    """(img [h, w, 3], mask [h, w], JSON body): seeded noise image and a
    rectangular hole of a seeded size and place."""
    import numpy as np

    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (h, w, 3), np.uint8)
    mask = np.full((h, w), 255, np.uint8)
    hh, ww = rng.randint(h // 8, h // 3), rng.randint(w // 8, w // 3)
    y, x = rng.randint(0, h - hh), rng.randint(0, w - ww)
    mask[y:y + hh, x:x + ww] = 0
    body = json.dumps({"image": _png_b64(img),
                       "mask": _png_b64(mask)}).encode()
    return img, mask, body


def _burst(port: int, bodies) -> list:
    """POST every body at once from its own thread; the replies as uint8
    arrays."""
    import io
    import threading
    import urllib.request

    import numpy as np
    from PIL import Image

    replies, errors = [None] * len(bodies), []

    def client(i):
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/inpaint", data=bodies[i],
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as resp:
                replies[i] = np.asarray(Image.open(io.BytesIO(resp.read())))
        except Exception as e:
            errors.append((i, repr(e)))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    check(not errors, f"serve: failed requests {errors}")
    return replies


def _load(port: int, bodies, what: str, tmp: str, gpu: str) -> dict:
    """Sustained closed-loop load from `python -m
    migan_tpu_torch.cli.loadgen` in a process of its own; prints each
    measured window."""
    import subprocess

    concurrency, requests = LOAD[what]
    path = os.path.join(tmp, what.replace(" ", "_") + ".jsonl")
    with open(path, "wb") as f:
        f.write(b"\n".join(bodies) + b"\n")
    r = subprocess.run(
        [sys.executable, "-m", "migan_tpu_torch.cli.loadgen", "--url",
         f"http://127.0.0.1:{port}/inpaint", "--bodies", path,
         "--concurrency", str(concurrency), "--warmup", str(LOAD_WARMUP),
         "--requests", str(requests), "--repeats", str(LOAD_REPEATS)],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=600)
    check(r.returncode == 0, f"{what}: loadgen failed: {r.stdout[-2000:]}"
          f"{r.stderr[-2000:]}")
    out = json.loads(r.stdout.strip().splitlines()[-1])
    for i, w in enumerate(out["windows"]):
        p99 = "n/a" if w["p99_ms"] is None else f"{w['p99_ms']:.1f} ms"
        print(f"phase5 {what} sustained, window {i + 1}/{LOAD_REPEATS}: "
              f"{w['requests']} replies in {w['seconds']:.3f} s = "
              f"{w['requests_per_s']:.2f} requests/s, latency p50 "
              f"{w['p50_ms']:.1f} ms p99 {p99} "
              f"({concurrency} clients in a closed loop, after "
              f"{LOAD_WARMUP} replies of warm-up; {gpu})", flush=True)
    return out


class _TimedForward:
    """A served forward that also sums the host-clock seconds of its calls,
    each ending with the rows on the host: at least the device time of the
    forwards."""

    def __init__(self, forward):
        self.forward, self.seconds = forward, 0.0

    def __call__(self, x):
        t0 = time.perf_counter()
        y = self.forward(x).cpu()
        self.seconds += time.perf_counter() - t0
        return y


def _serve(srv, batcher, bodies, what: str, tmp: str, gpu: str,
           results: dict, timed: _TimedForward = None) -> list:
    """Serve `bodies` at once, then the sustained load, each with the
    launch counts from 0; check batching and 19 launches per dispatch.
    With `timed`, the server's forward, and no other thread using the
    card, print the most of the sustained run the device can have been
    busy. Returns the burst's replies."""
    import threading

    from migan_tpu_torch.ops.kernels import (
        launch_counts, reset_launch_counts,
    )

    port = srv.server_address[1]
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    runs = {}
    try:
        for run in ("burst", "sustained"):
            n0 = len(batcher.batch_sizes_served)
            reset_launch_counts()
            if timed is not None:
                timed.seconds = 0.0
            if run == "burst":
                replies = _burst(port, bodies)
                sent = len(bodies)
            else:
                load = _load(port, bodies, what, tmp, gpu)
                sent = load["sent"]
            torch.cuda.synchronize()
            runs[run] = (sent, launch_counts(),
                         batcher.batch_sizes_served[n0:])
    finally:
        srv.shutdown()
        srv.server_close()
        batcher.close()
        thread.join()
    for run, (sent, counts, served) in runs.items():
        label = what if run == "burst" else f"{what} sustained"
        record_path(results, label, counts)
        want = {k: v * len(served)
                for k, v in EXPECTED_LAUNCHES[512].items()}
        check(sum(served) == sent, f"{label}: served {sum(served)} of "
              f"{sent}")
        check(max(served) > 1, f"{label}: no batched dispatch ({served})")
        check(counts == want, f"{label}: launches {counts}, expected "
              f"{want} for {len(served)} dispatches")
        print(f"phase5 {label}: {sent} requests in {len(served)} "
              f"dispatches (mean batch {sent / len(served):.2f}, largest "
              f"{max(served)}), launches {counts}", flush=True)
    if timed is not None:
        sent = runs["sustained"][0]
        busy_ms = 1e3 * timed.seconds / sent
        window_ms = 1e3 * (sum(w["seconds"] for w in load["windows"])
                           / sum(w["requests"] for w in load["windows"]))
        print(f"phase5 {what} sustained: the forwards took {busy_ms:.2f} ms "
              f"per request (host clock around each, to the rows on the "
              f"host; {timed.seconds:.3f} s for {sent} requests) against "
              f"{window_ms:.2f} ms per request in the windows: the device "
              f"busy {100 * busy_ms / window_ms:.1f}% of the time at most "
              f"({gpu})", flush=True)
    return replies


def _stage_ms(what: str, stages, gpu: str, reps: int = 20) -> None:
    """Median host-clock ms of each stage of one request, run in order
    on one thread, `reps` times; each stage takes the previous one's
    result and ends on the host (device work synchronised)."""
    times = {name: [] for name, _ in stages}
    for _ in range(reps):
        val = None
        for name, fn in stages:
            t0 = time.perf_counter()
            val = fn(val)
            torch.cuda.synchronize()
            times[name].append(1e3 * (time.perf_counter() - t0))
    parts = ", ".join(f"{name} {statistics.median(t):.1f}"
                      for name, t in times.items())
    print(f"phase5 {what}, one request's stages in ms (median of {reps}, "
          f"one thread, no other load): {parts} ({gpu})", flush=True)


def phase_serve(forward, tmp: str, gpu: str, results: dict) -> None:
    """The service as `python -m migan_tpu_torch.cli.serve ... --device
    cuda --warmup` builds it, in process, with phase 2's migan-512
    float32 forward (`load_model`)."""
    import numpy as np

    from migan_tpu_torch.cli import serve
    from migan_tpu_torch.data.preprocess import postprocess
    from migan_tpu_torch.export.pipeline import (
        make_pipeline, make_pipeline_stages,
    )

    # resize mode: 16 clients, max batch 8
    reqs = [_request(SEED + i, *DEMO_SIZES[i % len(DEMO_SIZES)])
            for i in range(16)]
    # the model thread is the only one that uses the card in resize mode
    timed = _TimedForward(forward)
    srv, batcher = serve.make_server(timed, 512, "127.0.0.1", 0,
                                     "migan-512", max_batch=8,
                                     window_ms=20.0)
    batcher.warmup()
    replies = _serve(srv, batcher, [b for _, _, b in reqs], "serve resize",
                     tmp, gpu, results, timed)
    worst = 0
    for (img, mask, body), got in zip(reqs, replies):
        x, img_r, mask_r = serve._decode_request(body, 512)
        y = forward(x).cpu().numpy()[0]
        want = np.asarray(postprocess(y, img_r, mask_r))
        check(got.shape == want.shape, f"serve resize: shape {got.shape}")
        worst = max(worst, int(np.abs(got.astype(np.int32) - want).max()))
    check(worst <= 1, f"serve resize: {worst} uint8 from the direct program")
    print(f"phase5 serve resize: every reply of the burst within {worst} "
          f"uint8 of the direct program (N = 1)", flush=True)
    body = reqs[0][2]
    _stage_ms("serve resize 512x512", [
        ("decode+preprocess", lambda _: serve._decode_request(body, 512)),
        ("forward N=1", lambda d: (forward(d[0]).cpu().numpy()[0], *d[1:])),
        ("postprocess", lambda d: np.asarray(postprocess(*d))),
        ("PNG encode", _png_bytes)], gpu)

    # pipeline mode: buckets 512,1024, 8 clients of mixed sizes
    reqs = [_request(SEED + 100 + i, w, h)
            for i, (w, h) in enumerate(PIPELINE_SIZES)]
    stages = make_pipeline_stages(512, device="cuda")
    runner = serve.PipelineRunner(
        stages, serve.MicroBatcher(forward, 512, max_batch=8,
                                   window_ms=20.0), [512, 1024])
    srv, _ = serve.make_server(forward, 512, "127.0.0.1", 0, "migan-512",
                               pipeline_runner=runner)
    runner.warmup()
    replies = _serve(srv, runner.batcher, [b for _, _, b in reqs],
                     "serve pipeline", tmp, gpu, results)
    pipeline, worst = make_pipeline(forward, 512, device="cuda"), 0
    for (_, _, body), got in zip(reqs, replies):
        # the server's decoding (a mask above 512 px passes through the
        # demo's 512 px NEAREST shrink and back)
        img, mask = serve._decode_pipeline_request(body)
        h, w = mask.shape
        b = runner.bucket_for(h, w)
        pi = np.zeros((1, b, b, 3), np.uint8)
        pm = np.full((1, b, b, 1), 255, np.uint8)
        pi[0, :h, :w], pm[0, :h, :w, 0] = img, mask
        want = pipeline(pi, pm).cpu().numpy()[0, :h, :w]
        check(got.shape == img.shape, f"serve pipeline: shape {got.shape}")
        worst = max(worst, int(np.abs(got.astype(np.int32) - want).max()))
        x_min, x_max, y_min, y_max = stages[0](pi, pm)[1].tolist()
        outside = np.ones((h, w), bool)
        outside[y_min:y_max, x_min:x_max] = False
        check(np.array_equal(got[outside], img[outside]),
              f"serve pipeline {w}x{h}: pixels outside the box changed")
    check(worst <= 1, f"serve pipeline: {worst} uint8 from make_pipeline")
    img, mask = serve._decode_pipeline_request(reqs[1][2])
    pi = np.zeros((1, 1024, 1024, 3), np.uint8)
    pm = np.full((1, 1024, 1024, 1), 255, np.uint8)
    pi[0, :768, :1024], pm[0, :768, :1024, 0] = img, mask
    _stage_ms("serve pipeline 1024x768", [
        ("decode", lambda _: serve._decode_pipeline_request(reqs[1][2])),
        ("pre", lambda _: stages[0](pi, pm)),
        ("forward N=1", lambda d: (forward(d[0]), d[1])),
        ("post", lambda d: stages[1](pi, pm, d[0], d[1]).cpu().numpy()),
        ("PNG encode", lambda y: _png_bytes(y[0, :768, :1024]))], gpu)
    print(f"phase5 serve pipeline: every reply of the burst within {worst} "
          f"uint8 of make_pipeline at its bucket, pixels outside the box "
          f"unchanged; buckets {runner.bucket_counts}", flush=True)


# ---------------------------------------------------------------------------
# Phase 6: the evaluation CLI on the card
# ---------------------------------------------------------------------------

# The evaluation's measured windows: EVAL_REPEATS windows of EVAL_WINDOW
# images each, after the first batch (the loader's start-up).
EVAL_BATCH, EVAL_WINDOW, EVAL_REPEATS = 8, 128, 3


def _eval_windows(batches) -> list:
    """(img/s, share of the time the loop waited for the loader) of each
    window of EVAL_WINDOW images, from `evaluate.main`'s per-batch log
    (end since the loop's start, items, wait), the first batch left out."""
    windows, start, items, waited = [], batches[0][0], 0, 0.0
    for end, n, wait in batches[1:]:
        items, waited = items + n, waited + wait
        if items == EVAL_WINDOW:
            windows.append((items / (end - start), waited / (end - start)))
            start, items, waited = end, 0, 0.0
    return windows


def _eval_device_ms(argv: list) -> float:
    """Device ms of one batch of the evaluation loop's work
    (`evaluate.score_batch`: generator, composite, LPIPS, Inception of the
    real and the composite images) as `evaluate.main(argv)` sets it up, on
    seeded inputs already on the card, launched back to back."""
    from migan_tpu_torch.cli import evaluate
    from migan_tpu_torch.cli.demo import load_model

    args = evaluate.get_args(argv)
    dev = torch.device("cuda")
    forward, res = load_model(args.model_name, args.model_path, args.dtype,
                              "cuda")
    inception, lp = evaluate.load_detectors(args, dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    imgs = torch.rand(EVAL_BATCH, res, res, 3, device=dev, generator=g)
    masks = (torch.rand(EVAL_BATCH, res, res, 1, device=dev, generator=g)
             < 0.7).float()
    imgs = imgs * 2 - 1
    x = torch.cat([masks - 0.5, imgs * masks], dim=-1)
    return cuda_ms(lambda: evaluate.score_batch(
        forward, inception, lp, x, imgs, masks, dev), reps=10)


def phase_evaluate(tmp: str, gpu: str, results: dict) -> None:
    import numpy as np
    from PIL import Image

    from migan_tpu_torch.cli import evaluate
    from migan_tpu_torch.evalx import inception, lpips
    from migan_tpu_torch.ops.kernels import (
        launch_counts, reset_launch_counts,
    )

    images = os.path.join(tmp, "eval_images")
    os.makedirs(images)
    rng = np.random.RandomState(SEED + 6)
    n_images = EVAL_BATCH + EVAL_REPEATS * EVAL_WINDOW
    for i in range(n_images):
        Image.fromarray(rng.randint(0, 256, (512, 512, 3), np.uint8)).save(
            os.path.join(images, f"{i:03d}.png"), compress_level=1)
    inc, lp = os.path.join(tmp, "inception.pth"), os.path.join(
        tmp, "lpips.pth")
    torch.save(inception.seeded_state_dict(SEED), inc)
    torch.save(lpips.seeded_state_dict(SEED + 1), lp)
    argv = ["--model-name", "migan-512", "--model-path",
            os.path.join(tmp, "migan512.npz"), "--real-dir", images,
            "--inception-weights", inc, "--lpips-weights", lp,
            "--batch-size", str(EVAL_BATCH)]

    runs = {}
    for label, extra in (("cuda float32", ["--device", "cuda"]),
                         ("cuda bfloat16", ["--device", "cuda",
                                            "--detector-dtype", "bfloat16"]),
                         ("cpu float32", ["--device", "cpu",
                                          "--max-items", "4"])):
        details = {}
        reset_launch_counts()
        fid, lpips_mean = evaluate.main(argv + extra, details=details)
        counts = launch_counts()
        # on the card: one forward per batch and the warm-up call's
        forwards = (0 if label.startswith("cpu")
                    else -(-details["n"] // EVAL_BATCH) + 1)
        if forwards:
            record_path(results, f"evaluate {label}", counts)
        want = {k: v * forwards for k, v in EXPECTED_LAUNCHES[512].items()}
        check(counts == want, f"evaluate {label}: launches {counts}, "
              f"expected {want}")
        check(np.isfinite(fid) and np.isfinite(details["lpips"]).all(),
              f"evaluate {label}: non-finite result")
        runs[label] = details
        print(f"phase6 evaluate {label}: {details['n']} images, FID "
              f"{fid:.6f}, LPIPS {lpips_mean:.6f}, launches {counts}",
              flush=True)
        if label.startswith("cpu"):
            continue
        windows = _eval_windows(details["batches"])
        check(len(windows) == EVAL_REPEATS, f"evaluate {label}: windows "
              f"{windows}")
        for i, (rate, wait) in enumerate(windows):
            print(f"phase6 evaluate {label}, window {i + 1}/{EVAL_REPEATS}: "
                  f"{EVAL_WINDOW} images at {rate:.2f} img/s, "
                  f"{100 * wait:.1f}% of it waiting for the loader (loop: "
                  f"decode, masks, generator, detectors; after a warm-up "
                  f"call and the first batch; {gpu})", flush=True)
        dev_ms = _eval_device_ms(argv + extra)
        loop_ms = [1e3 * EVAL_BATCH / rate for rate, _ in windows]
        print(f"phase6 evaluate {label}: one batch's device work alone "
              f"{dev_ms:.2f} ms (evaluate.score_batch on inputs already on "
              f"the card, launched back to back; CUDA events, mean of 10 "
              f"after 3) against {min(loop_ms):.1f}-{max(loop_ms):.1f} ms "
              f"per batch in the windows: the device busy "
              f"{100 * dev_ms / min(loop_ms):.1f}% of the loop at most "
              f"({gpu})", flush=True)

    def rel_l2(a, b):
        return (np.linalg.norm(a - b, axis=1) / np.linalg.norm(b, axis=1))

    card, cpu, bf16 = (runs["cuda float32"], runs["cpu float32"],
                       runs["cuda bfloat16"])
    d_lp = np.abs(card["lpips"][:4] - cpu["lpips"]).max()
    d_acts = max(rel_l2(card[k][:4], cpu[k]).max()
                 for k in ("real_acts", "fake_acts"))
    print(f"phase6 card vs CPU (4 items): per-image LPIPS max |diff| "
          f"{d_lp:.3e} (atol {EVAL_LPIPS_ATOL}), Inception activations "
          f"relative L2 max {d_acts:.3e} (limit {EVAL_ACTS_RTOL})",
          flush=True)
    # A composite that left the hole unfilled is the real image: the hold
    # above must be able to tell the two apart, image by image.
    moved = rel_l2(card["fake_acts"], card["real_acts"])
    print(f"phase6 each composite moves its Inception activations from its "
          f"real image's by relative L2 {moved.min():.3e} at least "
          f"(median {np.median(moved):.3e}), {moved.min() / EVAL_ACTS_RTOL:.0f}"
          f"x the card-vs-CPU limit at least", flush=True)
    check(moved.min() > EVAL_ACTS_RTOL, "evaluate: the activation hold "
          "could not tell a composite from its real image")
    check(d_lp <= EVAL_LPIPS_ATOL, "evaluate: card LPIPS differs from CPU")
    check(d_acts <= EVAL_ACTS_RTOL,
          "evaluate: card Inception activations differ from CPU")
    r_lp = (np.abs(bf16["lpips"] - card["lpips"])
            / (np.abs(card["lpips"]) + 1e-9)).max()
    r_acts = max(rel_l2(bf16[k], card[k]).max()
                 for k in ("real_acts", "fake_acts"))
    print(f"phase6 bf16 vs float32 detectors ({n_images} items): LPIPS "
          f"relative error max {r_lp:.3e} (limit {BF16_LPIPS_RTOL}), "
          f"Inception relative L2 max {r_acts:.3e} (limit "
          f"{BF16_ACTS_RTOL})",
          flush=True)
    check(r_lp < BF16_LPIPS_RTOL, "evaluate: bf16 LPIPS beyond its bound")
    check(r_acts < BF16_ACTS_RTOL,
          "evaluate: bf16 Inception activations beyond their bound")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from migan_tpu_torch.cli.trace import card
    from migan_tpu_torch.ops.kernels import _build

    # float32 as IEEE float32 on the card, which `load_model` also sets
    # for the CLIs; phase 1 runs before any `load_model`
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = card()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    print(f"kernel build: {_build.timed_build():.1f} s", flush=True)

    # library_ms: no single PyTorch call computes any of the fused blocks
    results = {k: {"name": k, "route": "cuda", "source": src,
                   "replaces": rep, "launches": 0, "max_abs_err": 0.0,
                   "library_ms": None, "shapes": []}
               for k, (src, rep) in SOURCES.items()}
    phase_kernels(results)
    with tempfile.TemporaryDirectory() as tmp:
        forwards = phase_generator(tmp, results)
        phase_demo(tmp, results)
        phase_times(forwards, gpu)
        phase_serve(forwards[512, "float32"][0], tmp, gpu, results)
        phase_evaluate(tmp, gpu, results)

    print(gpu)
    print(json.dumps({"kernels": [results[k] for k in SOURCES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
