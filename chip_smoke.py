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
     after warm-up, in turns), float32 and, for migan-512, bfloat16.

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


def phase_demo(tmp: str) -> None:
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from migan_tpu_torch.cli.trace import card
    from migan_tpu_torch.ops.kernels import _build

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
        phase_demo(tmp)
        phase_times(forwards, gpu)

    print(gpu)
    print(json.dumps({"kernels": [results[k] for k in SOURCES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
