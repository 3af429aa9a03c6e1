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
     3.35 TB/s and its pointwise product over the tensor cores' peak; at
     N = 1 in float32 it holds each kernel's max and mean distance from
     its plain version in float64 within 3x the plain float32 version's;
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
     warm-up, a window of 128 and of 100 replies) and prints each window's
     requests/s and p50/p99 latency, and in resize mode the most of the
     time the device can have been busy (the forwards' host-clock time
     per request against the windows'); checks for every run that the
     clients were batched and that the kernels launched 19 times per
     dispatch; times one request's stages in order on one thread;
  6. runs the evaluation CLI (`migan_tpu_torch.cli.evaluate.main`,
     `--device cuda`) on 136 seeded 512² PNGs with on-the-fly masks and
     seeded detector .pth files, holds its per-image LPIPS and Inception
     activations against the same CLI on the CPU (first 4 items, the
     plain versions), runs it again with bfloat16 detectors and holds
     that within the bf16 bound; prints img/s and the share of the loop
     spent waiting for the loader in a window of 128 images for both
     dtypes, and one batch's device work timed alone beside the loop's
     time per batch; then runs the CLI with `--data-parallel` as the one
     rank of `python -m torch.distributed.run --standalone
     --nproc-per-node 1` (NCCL on cuda:0) on the first 32 items and holds
     its all-gathered per-item LPIPS and activations within 1e-5
     relative L2 of the in-process run's, with its launches;
  7. exports: seeded migan-512 training weights (depthwise, 9 re-param
     tensors, non-zero noise strengths) through the export CLI
     (`migan_tpu_torch.cli.export`, `--device cuda`, 4 seeded images):
     the fold's diff statistic (against the plain folded net, as the
     reference computes it) below the JAX package's 0.5%, the kernel
     chain within 2e-3 of the plain folded net, both float32 nets'
     distances from the training net in float64 on one sample, migan.npz,
     and migan.pt2, the kernel chain through `torch.export`; loads the
     `.pt2` in a fresh process that imports only the port, holds it
     within 1e-6 of the live chain, counts 19 launches per forward and
     times both at N = 1; then the create_pipeline CLI (buckets 512,1024
     and dynamic H, W) and each loaded program on seeded images up to
     1024x768 within 1 uint8 of the live `make_pipeline` at the same
     bucket padding, pixels outside the box unchanged, 19 launches per
     call; prints both CLIs' wall times; the fold statistic through the
     kernel chain is held below 0.5% too;
  8. trains: the training CLI (`migan_tpu_torch.cli.train --experiment
     migan_places256`, full width, batch 32, a seeded full-width
     Co-Mod-GAN-256 teacher, R1 at step 0, `--max-steps 12`, a
     checkpoint every 2 ticks of 4 steps) in a process of its own with
     deterministic algorithms; a second run SIGKILLed after its first
     checkpoint and resumed to step 12 as the one rank of
     `torch.distributed.run` (an NCCL group of one rank: the gradients'
     and stats' all-reduces run on the card), its final state held
     bit-equal to the first run's; one step at batch 2 on the card
     against the CPU from the same state and noise; each phase's device
     ms with default and with deterministic algorithms, the peak memory
     of a batch-32 step, and the device's busy share in one
     deterministic step under torch.profiler; the export CLI on the
     checkpoint's `params_G_ema`. Prints s/kimg from the tick lines;
  9. trains the published FFHQ experiment with its in-loop FID: the
     training CLI (`--experiment migan_ffhq256`, full width, batch 32,
     the config's losses, phase 8's teacher, default algorithms) in a
     process of its own on a seeded `ffhq256x256.zip` (128 distinct val
     images, filler entries to the split at entry 10,000, 64 distinct
     train images) with native masks (`mask_backend=native`, the C++
     rasterizer built from `csrc/host/maskgen.cpp`) and a seeded
     TF-named Inception state dict, 12 steps in ticks of 4, an
     evaluation of `fid10k_full_inpainting` (capped at the 128 val
     items) at ticks 1 and 2; checks the `nvidia_tf` flavor in the log,
     one finite FID per evaluation in `metric-*.jsonl` and as
     `Metrics/fid` in stats.jsonl, one checkpoint under `weight/best/`
     at the lowest FID, one file in `fid-cache/` computed at the first
     evaluation and read at the second; holds the best checkpoint's
     `params_G_ema` through `compute_feature_stats_for_inpainting` on
     8 val items on the card against the CPU (features within 1e-3
     relative L2); prints s/kimg, each evaluation's time and its split
     (real stats, composite stats, Frechet distance), peak device
     memory and host masks/s at 256 on one thread, native against PIL.

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
from dataclasses import dataclass, field

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
# float32: each kernel's max and mean distance from its plain version in
# float64 may be at most this many times the plain float32 version's
F64_ERR_FACTOR = 3.0


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
    # times at every main-path shape, N = 1 and 8, both dtypes; at N = 1
    # in float32 each kernel's and the plain float32 version's distance
    # from the plain version in float64
    for dtype in (torch.float32, torch.bfloat16):
        for n in (1, 8):
            for case in main_path_cases(n, dtype):
                name, label = case.name, case.label
                fk, fp = case.kernel, case.plain
                ms, plain_ms = cuda_ms(fk), cuda_ms(fp)
                got, want = fk(), fp()
                torch.cuda.synchronize()
                outs = got if isinstance(got, tuple) else (got,)
                wants = want if isinstance(want, tuple) else (want,)
                err = max(max_err(a, b, dtype, f"{name} {label}")
                          for a, b in zip(outs, wants))
                bound_ms, bound_by = bound(case.args, outs, case.flops,
                                           dtype)
                dt = str(dtype)[6:]
                print(f"phase1 time {name} {label} {dt}: kernel {ms:.4f} "
                      f"ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} "
                      f"ms ({bound_by}), plain/kernel {plain_ms / ms:.2f}x, "
                      f"bound/kernel {bound_ms / ms:.3f}, max|diff| "
                      f"{err:.3e}", flush=True)
                row = {"shape": label, "dtype": dt, "ms": ms,
                       "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "max_abs_err": err}
                if dtype == torch.float32 and n == 1:
                    row.update(float64_check(case))
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


@dataclass
class Case:
    """One kernel call of a migan-512 forward: `args` the wrapper's
    positional tensors, `kw` its flags, `flops` the pointwise product's."""

    name: str
    label: str
    args: tuple
    flops: int
    kw: dict = field(default_factory=dict)

    def kernel(self):
        from migan_tpu_torch.ops.kernels import downblock, sepconv, upblock

        fn = {"sepconv": sepconv.fused_block,
              "downblock": downblock.fused_down_block,
              "upblock": upblock.fused_up_block}[self.name]
        return fn(*self.args, **self.kw)

    def plain(self, dtype=None):
        """The plain version, on the inputs cast to `dtype` if given."""
        from migan_tpu_torch.ops.kernels import downblock, sepconv, upblock

        fn = {"sepconv": sepconv.sepconv_plain,
              "downblock": downblock.downblock_plain,
              "upblock": upblock.upblock_plain}[self.name]
        args = self.args if dtype is None else tuple(
            None if a is None else a.to(dtype) for a in self.args)
        return fn(*args, **self.kw)


def main_path_cases(n: int, dtype) -> list:
    """A `Case` for each distinct kernel shape of a migan-512 forward at
    batch n, in call order; upblock as the forward calls it (rgb only at
    the top level). Seeded inputs made on the card."""
    from migan_tpu_torch.models.migan_inference import GeneratorConfig
    from migan_tpu_torch.models.migan_kernels import kernel_shapes

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
            cases.append(Case(name, f"[{n},{h},{w},{c}]->{o} final_act={fa}",
                              (r(n, h, w, c), *sep), 2 * n * h * w * c * o,
                              {"final_act": fa}))
        elif name == "downblock":
            cases.append(Case(name, f"[{n},{h},{w},{c}]->{o}",
                              (r(n, h, w, c), *sep),
                              2 * n * (h // 2) * (w // 2) * c * o))
        else:
            emit = 2 * h != top
            args = (r(n, h, w, c), r(n, 2 * h, 2 * w, c),
                    r(2 * h, 2 * w, scale=.3), *sep,
                    r(2 * h, 2 * w, scale=.3), r(o, 3, scale=o ** -.5),
                    r(3, scale=.1))
            cases.append(Case(name, f"x_lo [{n},{h},{w},{c}]->{o} "
                              f"{'feat+rgb' if emit else 'rgb only'}",
                              args, 2 * n * 4 * h * w * c * o,
                              {"emit_features": emit}))
    return cases


def _errors(got, truth) -> dict:
    """max and mean |got - truth| over every output element."""
    def flat(out):
        outs = out if isinstance(out, tuple) else (out,)
        return torch.cat([t.double().flatten() for t in outs])

    d = (flat(got) - flat(truth)).abs()
    return {"max": d.max().item(), "mean": d.mean().item()}


def float64_check(case: Case) -> dict:
    """The kernel's and the plain float32 version's max and mean distance
    from the plain version in float64; fails when the kernel's is beyond
    F64_ERR_FACTOR times the plain version's."""
    truth = case.plain(torch.float64)
    k, p = _errors(case.kernel(), truth), _errors(case.plain(), truth)
    ratio = {s: k[s] / p[s] for s in ("max", "mean")}
    print(f"phase1 float64 {case.name} {case.label}: kernel max "
          f"{k['max']:.3e} mean {k['mean']:.3e}, plain float32 max "
          f"{p['max']:.3e} mean {p['mean']:.3e}, ratio "
          f"{ratio['max']:.2f}x / {ratio['mean']:.2f}x", flush=True)
    for s in ("max", "mean"):
        check(k[s] <= F64_ERR_FACTOR * p[s], f"{case.name} {case.label}: "
              f"{s} error against float64 {k[s]:.3e}, beyond "
              f"{F64_ERR_FACTOR}x the plain float32 version's {p[s]:.3e}")
    return {"f32_err_vs_f64": k, "plain_f32_err_vs_f64": p}


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
LOAD_WARMUP, LOAD_REPEATS = 32, 1
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
EVAL_BATCH, EVAL_WINDOW, EVAL_REPEATS = 8, 128, 1


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
        if label.startswith("cpu"):
            # the one-rank evaluation's process, mostly host work (process
            # start-up, the FID's matrix square root), runs beside the CPU
            # run, which times nothing
            one_rank = _start_one_rank_evaluate(tmp, argv)
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
    _finish_one_rank_evaluate(one_rank, card, gpu, results)


def _start_one_rank_evaluate(tmp: str, argv: list) -> dict:
    """Starts the evaluation CLI with --data-parallel as the one rank of
    `torch.distributed.run` on the first DP_EVAL_ITEMS items, in a
    session of its own that is killed at exit if it is still running."""
    import atexit
    import signal
    import subprocess

    run = {"out": os.path.join(tmp, "eval_dp.npz"),
           "log": os.path.join(tmp, "eval_dp.log"),
           "t0": time.perf_counter()}
    cmd = (_one_rank(tmp, "eval_launcher", EVAL_LAUNCHER) + [run["out"]]
           + argv + ["--device", "cuda", "--data-parallel", "--max-items",
                     str(DP_EVAL_ITEMS)])
    with open(run["log"], "w") as log:
        run["proc"] = subprocess.Popen(
            cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
            env=_repo_env(), stdout=log, stderr=subprocess.STDOUT,
            text=True, start_new_session=True)

    def kill(proc=run["proc"]):
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)

    atexit.register(kill)
    return run


def _finish_one_rank_evaluate(run: dict, inproc: dict, gpu: str,
                              results: dict) -> None:
    """Waits for `_start_one_rank_evaluate`'s run; holds its all-gathered
    (zipzapped) per-item LPIPS and activations against the in-process
    run's on the same items, and counts its launches."""
    import numpy as np

    rc = run["proc"].wait(timeout=600)
    wall = time.perf_counter() - run["t0"]
    with open(run["log"]) as f:
        log = f.read()
    check(rc == 0, f"phase6 data-parallel evaluate: exit {rc}\n"
          f"{log[-4000:]}")
    check(ONE_RANK_LINE in log, f"phase6 data-parallel evaluate: no "
          f"{ONE_RANK_LINE!r} line")
    got = np.load(run["out"])
    counts = json.loads(str(got["counts"]))
    record_path(results, "evaluate --data-parallel, 1 NCCL rank", counts)
    forwards = -(-DP_EVAL_ITEMS // EVAL_BATCH) + 1
    want = {k: v * forwards for k, v in EXPECTED_LAUNCHES[512].items()}
    check(counts == want, f"phase6 data-parallel evaluate: launches "
          f"{counts}, expected {want}")
    n = DP_EVAL_ITEMS
    lp = got["lpips"]
    rel_lp = float(np.linalg.norm(lp - inproc["lpips"][:n])
                   / np.linalg.norm(inproc["lpips"][:n]))
    rel_acts = max(float((np.linalg.norm(got[k] - inproc[k][:n], axis=1)
                          / np.linalg.norm(inproc[k][:n], axis=1)).max())
                   for k in ("real_acts", "fake_acts"))
    print(f"phase6 evaluate --data-parallel as the one rank of "
          f"torch.distributed.run ({ONE_RANK_LINE}), first {n} items: "
          f"FID {float(got['fid']):.6f}; all-gathered per-item LPIPS "
          f"relative L2 {rel_lp:.3e}, Inception activations relative L2 "
          f"max {rel_acts:.3e} against the in-process run (limit "
          f"{DP_EVAL_RTOL}); launches {counts}; {wall:.1f} s wall, "
          f"process start to exit, beside the CPU run ({gpu})", flush=True)
    check(lp.shape == (n,) and max(rel_lp, rel_acts) <= DP_EVAL_RTOL,
          "phase6 data-parallel evaluate differs from the in-process run")


# The evaluation CLI as the one rank of an NCCL group (torch.distributed
# .run): argv[1] is the .npz it writes (FID, per-item LPIPS, activations,
# the kernels' launches), the rest the CLI's arguments.
EVAL_LAUNCHER = r"""
import json, os, sys
import numpy as np
from migan_tpu_torch.cli import evaluate
from migan_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
assert os.environ["WORLD_SIZE"] == "1"
details = {}
reset_launch_counts()
fid, _ = evaluate.main(sys.argv[2:], details=details)
np.savez(sys.argv[1], fid=fid, lpips=details["lpips"],
         real_acts=details["real_acts"], fake_acts=details["fake_acts"],
         counts=json.dumps(launch_counts()))
"""
# Its items (the first of phase 6's) and its bound against the in-process
# run: the same kernels and detectors on the same inputs, in another
# process.
DP_EVAL_ITEMS, DP_EVAL_RTOL = 32, 1e-5


# ---------------------------------------------------------------------------
# Phase 7: the export workload on the card
# ---------------------------------------------------------------------------

EXPORT_SAMPLES = 4
# the JAX package's bound on the fold statistic (tests/test_export.py:46)
FOLD_DIFF_LIMIT = 0.5
# a loaded `.pt2` runs the same kernels on the same inputs as the live
# chain: any difference beyond this is a fault
PT2_ATOL = 1e-6
# (w, h) of the pipeline self-check's images: both buckets
PIPELINE_CHECK_SIZES = ((512, 512), (1024, 768), (640, 480), (300, 700))

# Run in a fresh interpreter that imports only the port: load the export
# CLI's migan.pt2, count one forward's launches, hold it against the live
# chain (`load_model` of the same folded weights), time both at N = 1
# (median of 20 after 3, in turns) and count the ATen ops (custom ops
# included) each forward dispatches. Prints one JSON line.
FRESH_PT2 = r"""
import json, statistics, sys, time
import torch
import migan_tpu_torch.ops.kernels as kernels
from migan_tpu_torch.cli.demo import load_model
from migan_tpu_torch.export import torch_export
pt2, npz, res, seed = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
t0 = time.perf_counter()
program = torch_export.load(pt2)
load_s = time.perf_counter() - t0
live, _ = load_model(f"migan-{res}", npz, device="cuda")
g = torch.Generator(device="cuda").manual_seed(seed)
x = torch.rand(1, res, res, 4, device="cuda", generator=g) * 2 - 1
kernels.reset_launch_counts()
y = program(x)
torch.cuda.synchronize()
counts = kernels.launch_counts()
want = live(x)
times = {"pt2": [], "live": []}
for _ in range(3):
    program(x), live(x)
torch.cuda.synchronize()
for i in range(20):
    order = [("pt2", program), ("live", live)]
    for name, f in (order if i % 2 == 0 else order[::-1]):
        t0 = time.perf_counter()
        f(x)
        torch.cuda.synchronize()
        times[name].append(time.perf_counter() - t0)
from collections import Counter
from torch.utils._python_dispatch import TorchDispatchMode
class Count(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))
ops = {}
for name, f in (("pt2", program), ("live", live)):
    with Count() as c:
        c.ops = Counter()
        f(x)
    ops[name] = c.ops
ops_diff = {k: ops["pt2"][k] - ops["live"][k]
            for k in set(ops["pt2"]) | set(ops["live"])
            if ops["pt2"][k] != ops["live"][k]}
ops = {k: sum(v.values()) for k, v in ops.items()}
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "migan_tpu"))
print(json.dumps({
    "counts": counts, "max_abs_err": (y - want).abs().max().item(),
    "shape": list(y.shape), "finite": bool(torch.isfinite(y).all()),
    "load_s": load_s, "bad_modules": bad, "ops": ops,
    "ops_diff": ops_diff,
    "pt2_ms": [1e3 * t for t in times["pt2"]],
    "live_ms": [1e3 * t for t in times["live"]]}))
"""


def _write_pairs(root: str, sizes, seed: int) -> list:
    """Seeded noise PNGs with a rectangular hole each under root/images
    and root/masks; returns [(img, mask)]."""
    from PIL import Image

    images, masks = os.path.join(root, "images"), os.path.join(root, "masks")
    os.makedirs(images)
    os.makedirs(masks)
    pairs = []
    for i, (w, h) in enumerate(sizes):
        img, mask, _ = _request(seed + i, w, h)
        Image.fromarray(img).save(os.path.join(images, f"{i}.png"))
        Image.fromarray(mask).save(os.path.join(masks, f"{i}.png"))
        pairs.append((img, mask))
    return pairs


def _float64_distances(train: str, npz: str, root: str, gpu: str) -> None:
    """The export CLI's first sample through the training net in float64
    (cuDNN), and through the folded net in float32, plain (cuDNN) and as
    the kernel chain: each one's distance from the float64 output and the
    fold statistic's count against it (`np.isclose(rtol=1e-3)`, per
    512² pixels)."""
    from migan_tpu_torch.cli.export import _sample_input
    from migan_tpu_torch.export.fold import diff_count
    from migan_tpu_torch.io import load_npz, load_train_generator
    from migan_tpu_torch.models import migan
    from migan_tpu_torch.models.migan_inference import generator_apply
    from migan_tpu_torch.models.migan_kernels import KernelGenerator

    cfg = migan.MiganConfig(resolution=512)
    img = sorted(os.listdir(os.path.join(root, "images")))[0]
    x = torch.from_numpy(_sample_input(os.path.join(root, "images", img),
                                       os.path.join(root, "masks"),
                                       512)[2]).cuda()
    with torch.no_grad():
        g64 = load_train_generator(train, cfg).cuda().double().eval()
        truth = migan.generator_apply(g64, x.double(),
                                      noise_mode="const").float()
        del g64
        folded = load_npz(npz).cuda().eval()
        outs = {"plain folded net": generator_apply(folded, x),
                "kernel chain": KernelGenerator(folded)(x)}
    for name, y in outs.items():
        d = (y - truth).abs()
        print(f"phase7 float32 {name} vs the training net in float64 (one "
              f"512² sample): max|diff| {d.max().item():.3e}, mean "
              f"{d.mean().item():.3e}, diff statistic against it "
              f"{100 * diff_count(truth, y) / 512 ** 2:.4f}% (|output| "
              f"max {truth.abs().max().item():.3f}; {gpu})", flush=True)


def phase_export(tmp: str, gpu: str, results: dict) -> None:
    """`cli.export` on seeded migan-512 training weights, its `.pt2` in a
    fresh process, then `cli.create_pipeline` and its programs against
    the live pipeline."""
    import subprocess

    import numpy as np

    from migan_tpu_torch.cli import create_pipeline, export
    from migan_tpu_torch.cli.demo import load_model
    from migan_tpu_torch.export import torch_export
    from migan_tpu_torch.export.pipeline import make_pipeline
    from migan_tpu_torch.io import save_train_npz
    from migan_tpu_torch.models import migan
    from migan_tpu_torch.ops.kernels import (
        launch_counts, reset_launch_counts,
    )

    def per(forwards):
        return {k: v * forwards for k, v in EXPECTED_LAUNCHES[512].items()}

    # seeded migan-512 training weights at full width (depthwise, 9
    # re-param tensors), seeded non-zero noise strengths
    cfg = migan.MiganConfig(resolution=512)
    gen = torch.Generator().manual_seed(SEED + 7)
    g = migan.generator_init(cfg, gen)
    with torch.no_grad():
        for name, p in g.named_parameters():
            if name.endswith("noise_strength"):
                p.copy_(torch.randn((), generator=gen) * 0.3)
    train = os.path.join(tmp, "train512.npz")
    save_train_npz(train, g)
    print(f"phase7 training G: {migan.count_params(g):,} parameters "
          f"(migan-512, depthwise, 9 re-param tensors)", flush=True)
    del g

    root = os.path.join(tmp, "export")
    _write_pairs(root, DEMO_SIZES + ((768, 512),), SEED + 200)
    out = os.path.join(root, "out")
    reset_launch_counts()
    t0 = time.perf_counter()
    stats = export.main([
        "--model-path", train, "--resolution", "512", "--origs-dir",
        os.path.join(root, "images"), "--masks-dir",
        os.path.join(root, "masks"), "--output-dir", out, "--num-samples",
        str(EXPORT_SAMPLES), "--device", "cuda"])
    torch.cuda.synchronize()
    export_s = time.perf_counter() - t0
    counts = launch_counts()
    record_path(results, "export", counts)
    # the diff statistic's forwards; tracing launches nothing
    check(counts == per(EXPORT_SAMPLES), f"export: launches {counts}, "
          f"expected {per(EXPORT_SAMPLES)}")
    pct = stats["diff_pct"]
    check(pct < FOLD_DIFF_LIMIT, f"export: fold diff {pct}% beyond "
          f"{FOLD_DIFF_LIMIT}%")
    check(stats["chain_diff_pct"] < FOLD_DIFF_LIMIT, f"export: fold diff "
          f"through the kernel chain {stats['chain_diff_pct']}% beyond "
          f"{FOLD_DIFF_LIMIT}%")
    check(stats["chain_max_abs_diff"] <= GEN_ATOL, f"export: the kernel "
          f"chain {stats['chain_max_abs_diff']} from the plain folded net")
    pt2 = os.path.join(out, "models", "migan.pt2")
    npz = os.path.join(out, "models", "migan.npz")
    _float64_distances(train, npz, root, gpu)
    print(f"phase7 export CLI: Average diff {pct:.6f}% over "
          f"{EXPORT_SAMPLES} images (the fold: train-G const vs the plain "
          f"folded net; limit {FOLD_DIFF_LIMIT}%); through the kernel "
          f"chain {stats['chain_diff_pct']:.6f}%, the chain within "
          f"{stats['chain_max_abs_diff']:.3e} of the plain folded net "
          f"(limit {GEN_ATOL}); "
          f"{export_s:.2f} s wall (fold, diff statistic, migan.npz, "
          f"torch.export of the kernel chain, {os.path.getsize(pt2):,} "
          f"bytes of .pt2), launches {counts} ({gpu})", flush=True)

    r = subprocess.run(
        [sys.executable, "-c", FRESH_PT2, pt2, npz, "512", str(SEED + 8)],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=600)
    check(r.returncode == 0, f"export .pt2 in a fresh process failed: "
          f"{r.stdout[-2000:]}{r.stderr[-3000:]}")
    fresh = json.loads(r.stdout.strip().splitlines()[-1])
    record_path(results, "export .pt2 (fresh process)", fresh["counts"])
    check(fresh["counts"] == per(1), f"export .pt2: launches "
          f"{fresh['counts']}, expected {per(1)}")
    check(not fresh["bad_modules"], f"export .pt2: the fresh process "
          f"imported {fresh['bad_modules']}")
    check(fresh["finite"] and fresh["shape"] == [1, 512, 512, 3],
          f"export .pt2: output {fresh['shape']}, finite "
          f"{fresh['finite']}")
    check(fresh["max_abs_err"] <= PT2_ATOL, f"export .pt2: "
          f"{fresh['max_abs_err']} from the live chain")
    pt2_ms = statistics.median(fresh["pt2_ms"])
    live_ms = statistics.median(fresh["live_ms"])
    print(f"phase7 export .pt2 in a fresh process: loaded in "
          f"{fresh['load_s']:.2f} s, launches {fresh['counts']} per "
          f"forward, max|diff| from the live chain "
          f"{fresh['max_abs_err']:.3e} (limit {PT2_ATOL})", flush=True)
    print(f"phase7 migan-512 N=1 float32 forward: loaded .pt2 "
          f"{pt2_ms:.3f} ms, live chain {live_ms:.3f} ms (median of 20 "
          f"after 3, in turns, one process; .pt2 spread "
          f"{min(fresh['pt2_ms']):.3f}-{max(fresh['pt2_ms']):.3f}, live "
          f"{min(fresh['live_ms']):.3f}-{max(fresh['live_ms']):.3f}; "
          f"{gpu}); ops dispatched per forward: .pt2 {fresh['ops']['pt2']}, "
          f"live {fresh['ops']['live']}, the difference by op "
          f"{fresh['ops_diff']}", flush=True)

    pipe_root = os.path.join(tmp, "pipeline")
    pairs = _write_pairs(pipe_root, PIPELINE_CHECK_SIZES, SEED + 300)
    reset_launch_counts()
    t0 = time.perf_counter()
    written = create_pipeline.main([
        "--resolution", "512", "--model-path", npz, "--images-dir",
        os.path.join(pipe_root, "images"), "--masks-dir",
        os.path.join(pipe_root, "masks"), "--output-dir",
        os.path.join(pipe_root, "out"), "--device", "cuda", "--buckets",
        "512,1024", "--polymorphic"])
    torch.cuda.synchronize()
    pipe_s = time.perf_counter() - t0
    counts = launch_counts()
    record_path(results, "create_pipeline", counts)
    check(set(written) == {"512", "1024", "dynamic"},
          f"create_pipeline wrote {sorted(written)}")
    # its self-check: one bucket program call per image
    check(counts == per(len(pairs)), f"create_pipeline: launches "
          f"{counts}, expected {per(len(pairs))}")
    print(f"phase7 create_pipeline CLI: buckets 512,1024 and dynamic H, W "
          f"exported and {len(pairs)} images self-checked in {pipe_s:.2f} "
          f"s wall, launches {counts} ({gpu})", flush=True)

    forward, _ = load_model("migan-512", npz, device="cuda")
    live = make_pipeline(forward, 512, device="cuda")
    programs = {k: torch_export.load(v) for k, v in written.items()}
    worst, calls = 0, 0
    total = {k: 0 for k in EXPECTED_LAUNCHES[512]}
    for img, mask in pairs:
        h, w = mask.shape
        b = 512 if max(h, w) <= 512 else 1024
        pi = np.zeros((1, b, b, 3), np.uint8)
        pm = np.full((1, b, b, 1), 255, np.uint8)
        pi[0, :h, :w], pm[0, :h, :w, 0] = img, mask
        for name, (ti, tm) in ((str(b), (pi, pm)),
                               ("dynamic", (img[None], mask[None, :, :,
                                                            None]))):
            ti = torch.from_numpy(np.ascontiguousarray(ti)).cuda()
            tm = torch.from_numpy(np.ascontiguousarray(tm)).cuda()
            reset_launch_counts()
            got = programs[name](ti, tm)
            torch.cuda.synchronize()
            c = launch_counts()
            check(c == per(1), f"create_pipeline {name} program {w}x{h}: "
                  f"launches {c}")
            for k in total:
                total[k] += c[k]
            calls += 1
            want = live(ti, tm)
            got, want = got.cpu().numpy(), want.cpu().numpy()
            worst = max(worst, int(np.abs(got.astype(np.int32)
                                          - want).max()))
            x_min, x_max, y_min, y_max = live.pre(ti, tm)[1].tolist()
            outside = np.ones(got.shape[1:3], bool)
            outside[y_min:y_max, x_min:x_max] = False
            check(np.array_equal(got[0][outside],
                                 ti.cpu().numpy()[0][outside]),
                  f"create_pipeline {name} {w}x{h}: pixels outside the box "
                  f"changed")
    record_path(results, "create_pipeline .pt2", total)
    check(worst <= 1, f"create_pipeline: a program {worst} uint8 from the "
          f"live pipeline")
    print(f"phase7 create_pipeline programs: {calls} calls (each image "
          f"through its bucket's program and the dynamic one), every output "
          f"within {worst} uint8 of the live make_pipeline, pixels outside "
          f"the box unchanged, {per(1)} launches per call", flush=True)


# ---------------------------------------------------------------------------
# Phase 8: training on the card
# ---------------------------------------------------------------------------

TRAIN_STEPS = 12          # R1 runs at step 0 (d_reg_interval 16)
TRAIN_BATCH = 32          # the config's own
TICK_STEPS = 4            # a tick of 4 steps, a checkpoint every 2 ticks
CKPT_TICKS = 2
# one step at batch 2 on the card against the CPU (TF32 off): the losses
# and each phase's gradient (all its parameters' gradients as one vector,
# relative L2), float32 sums in another order through ~60 layers (G, D,
# the Co-Mod-GAN teacher; the losses read 0 to 5.3e-6 apart, relative, on
# an H100: PERF.md section 6). Single tensors of R1's gradient (the biases,
# norms ~1e-7) are further apart, between float32 and float64 on one CPU
# too (up to 2e-2 at 256 px): printed, not held.
STEP_LOSS_RTOL, STEP_GRAD_RTOL = 1e-4, 1e-3
STEP_LOSSES = ("Loss/G/loss", "Loss/G/kd_l1_image_level_loss", "Loss/D/loss",
               "Loss/D/reg", "Loss/r1_penalty")
PHASE_REPS = 3            # timed steps after 2 warm-up steps
STEP_WINDOW = "migan_train_step"

# The start line of a port CLI run as the one rank of an NCCL group
ONE_RANK_LINE = "distributed: backend nccl, world 1, rank 0, device cuda:0"
# The training CLI in a process of its own, with deterministic algorithms
# (set here, by the launcher, not by a flag of the CLI), so that a killed
# and resumed run can be held bit-equal to the uninterrupted one.
TRAIN_LAUNCHER = r"""
import sys
import torch
torch.use_deterministic_algorithms(True)
from migan_tpu_torch.cli.train import main
main(sys.argv[1:])
"""


def _train_argv(teacher: str, log_root: str, signature: str) -> list:
    return ["--experiment", "migan_places256", "--signature", signature,
            "--max-steps", str(TRAIN_STEPS),
            "--set", "train.dataset.root_dir=data/Places2-demo",
            "--set", f"train.image_level_kd_kwargs.teacher1_path={teacher}",
            "--set", "train.metrics=[]",
            "--set", f"env.log_root_dir={log_root}",
            "--set", f"train.kimg_per_tick="
                     f"{TICK_STEPS * TRAIN_BATCH / 1000}",
            "--set", f"train.snapshot.checkpoint={CKPT_TICKS}"]


def _one_rank(tmp: str, name: str, source: str) -> list:
    """The command that runs `source`, written to `<tmp>/<name>.py`, as
    the one rank of `python -m torch.distributed.run --standalone
    --nproc-per-node 1` (the port's CLIs then join an NCCL group of one
    rank on cuda:0); the repo on PYTHONPATH."""
    path = os.path.join(tmp, f"{name}.py")
    with open(path, "w") as f:
        f.write(source)
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", "1", path]


def _repo_env(**extra) -> dict:
    repo = os.path.dirname(os.path.abspath(__file__))
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, PYTHONPATH=repo + (os.pathsep + path if path
                                               else ""), **extra)


def _train_process(argv: list, out_path: str, launcher=None):
    """The training CLI in a process of its own, or under `launcher` (a
    command from `_one_rank`)."""
    import subprocess

    cmd = (launcher or [sys.executable, "-c", TRAIN_LAUNCHER]) + argv
    out = open(out_path, "w")
    proc = subprocess.Popen(
        cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
        env=_repo_env(CUBLAS_WORKSPACE_CONFIG=":4096:8"),
        stdout=out, stderr=subprocess.STDOUT, text=True)
    return proc, out


def _run_dir(log_root: str) -> str:
    (name,) = os.listdir(log_root)
    return os.path.join(log_root, name)


def _tick_lines(out_path: str) -> list:
    with open(out_path) as f:
        return [l.strip() for l in f if l.startswith("tick ")]


def _check_train_run(proc, out, out_path: str, what: str) -> None:
    rc = proc.wait(timeout=900)
    out.close()
    if rc != 0:
        with open(out_path) as f:
            log = f.read()
        raise RuntimeError(f"phase8 {what}: exit {rc}\n{log[-4000:]}")


def _state_equal(a: dict, b: dict, path: str = "") -> list:
    """Paths where two checkpoint state dicts differ (tensors bit for
    bit, everything else by ==)."""
    if isinstance(a, dict):
        if set(a) != set(b):
            return [path + " (keys)"]
        return [d for k in a for d in _state_equal(a[k], b[k],
                                                   f"{path}.{k}")]
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return [path + " (length)"]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in _state_equal(x, y, f"{path}[{i}]")]
    if isinstance(a, torch.Tensor):
        return [] if torch.equal(a, b) else [path]
    return [] if a == b else [path]


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def _train_setup(device, teacher_path: str, batch: int):
    """(TrainStep, TrainState, batch dict, teacher fn) of migan_places256
    at full width on `device`, G and D from the seed, the teacher from
    `teacher_path`, a batch of the demo images with their masks."""
    from migan_tpu_torch.data.factory import get_dataset
    from migan_tpu_torch.data.sampler import DataLoader
    from migan_tpu_torch.models.registry import get_model
    from migan_tpu_torch.train import loop, train_step
    from migan_tpu_torch.utils.config import ConfigBanks, apply_overrides

    cfg = ConfigBanks("configs").experiment("migan_places256")
    apply_overrides(cfg, ["train.dataset.root_dir=data/Places2-demo",
                          "train.image_level_kd_kwargs.teacher1_path="
                          + teacher_path, f"train.batch_size={batch}"])
    cfgt = cfg["train"]
    g_cfg = get_model()(cfg["model_g"]).cfg
    d_cfg = get_model()(cfg["model_d"]).cfg
    tcfg = loop._train_config_from_cfg(cfgt)
    teacher = loop._make_teacher(cfgt, device)
    state = train_step.init_train_state(torch.Generator().manual_seed(SEED),
                                        g_cfg, d_cfg, tcfg, device)
    step = train_step.make_train_step(g_cfg, d_cfg, tcfg, teacher=teacher)
    x, mask, _ = next(iter(DataLoader(get_dataset(cfgt["dataset"]), batch,
                                      num_workers=4, seed=SEED)))
    data = {"real": torch.from_numpy(x).to(device),
            "mask": torch.from_numpy(mask[..., None]).to(device)}
    return step, state, data


def _card_vs_cpu_step(teacher_path: str, gpu: str) -> None:
    """One step (Gmain with the teacher, Dmain, Dreg) at batch 2 on the
    card and on the CPU, each phase from the same state and the same
    noise (CPU generators: `migan.randn` draws on the generator's
    device). After each phase the card's state is set to the CPU's: with
    beta1 = 0 the first Adam update is ~lr sign(g), which flips where a
    gradient is within rounding of 0, and would start the next phase from
    states 2 lr apart there."""
    from migan_tpu_torch.train import train_step
    from migan_tpu_torch.train.train_step import decode_batch

    runs = {dev: _train_setup(torch.device(dev), teacher_path, 2)
            for dev in ("cpu", "cuda")}
    gens = {dev: torch.Generator().manual_seed(SEED + 20) for dev in runs}
    out = {dev: ({}, []) for dev in runs}
    orig = train_step._apply
    for phase in ("g", "d", "r1"):
        for dev, (step, state, data) in runs.items():
            real, mask = decode_batch(data["real"], data["mask"])
            grads = out[dev][1]

            def spy(opt, params, g, grads=grads):
                grads.append([t.detach().cpu() for t in g])
                orig(opt, params, g)

            train_step._apply = spy
            try:
                if phase == "r1":
                    stats = step.r1_phase(state, real, mask)
                else:
                    stats = getattr(step, f"{phase}_phase")(
                        state, real, mask, gens[dev])
            finally:
                train_step._apply = orig
            out[dev][0].update({k: float(v) for k, v in stats.items()})
        runs["cuda"][1].load_state_dict(runs["cpu"][1].state_dict())
    del runs
    runs = out
    (s_cpu, g_cpu), (s_gpu, g_gpu) = runs["cpu"], runs["cuda"]
    rel = {k: abs(s_gpu[k] - s_cpu[k]) / max(abs(s_cpu[k]), 1e-30)
           for k in STEP_LOSSES}
    for k in STEP_LOSSES:
        check(rel[k] <= STEP_LOSS_RTOL, f"phase8 card vs CPU: {k} {s_gpu[k]} "
              f"against {s_cpu[k]} (rtol {STEP_LOSS_RTOL})")
    whole, worst = {}, {}
    for phase, a, b in zip(("Gmain", "Dmain", "Dreg"), g_gpu, g_cpu):
        whole[phase] = _rel_l2(torch.cat([x.flatten() for x in a]),
                               torch.cat([y.flatten() for y in b]))
        worst[phase] = max(_rel_l2(x, y) for x, y in zip(a, b))
        check(whole[phase] <= STEP_GRAD_RTOL, f"phase8 card vs CPU: "
              f"{phase} gradient relative L2 {whole[phase]:.3e}, limit "
              f"{STEP_GRAD_RTOL}")
    print(f"phase8 one step at batch 2, card vs CPU (TF32 off, same state "
          f"and noise): losses relative "
          + ", ".join(f"{k.split('/', 1)[1]} {v:.2e}" for k, v in rel.items())
          + f" (rtol {STEP_LOSS_RTOL}); gradient "
          f"relative L2 per phase "
          + ", ".join(f"{k} {v:.3e}" for k, v in whole.items())
          + f" (limit {STEP_GRAD_RTOL}), its worst single tensor "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + f" ({gpu})", flush=True)


def _phase_times(teacher_path: str, gpu: str) -> None:
    """Median device ms of each phase of a batch-32 step by CUDA events
    after 2 warm-up steps, the teacher's forward alone, and the peak
    device memory of a step: with PyTorch's default algorithms, then with
    deterministic algorithms, as the training CLI runs here. Then one
    deterministic step (Gmain, Dmain, EMA) under torch.profiler: the
    device's busy share, the union of its device events' intervals over
    the step's host-clock window (as `cli/trace.py` measures a forward)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from migan_tpu_torch.cli.trace import busy_union
    from migan_tpu_torch.train.train_step import decode_batch

    dev = torch.device("cuda")
    step, state, data = _train_setup(dev, teacher_path, TRAIN_BATCH)
    gen = torch.Generator(dev).manual_seed(SEED + 21)
    real, mask = decode_batch(data["real"], data["mask"])
    phases = {
        "Gmain (with the teacher)": lambda: step.g_phase(state, real, mask,
                                                         gen),
        "teacher forward alone": lambda: step.teacher(
            torch.cat([mask - 0.5, real * mask], dim=-1), gen),
        "Dmain": lambda: step.d_phase(state, real, mask, gen),
        "Dreg (R1)": lambda: step.r1_phase(state, real, mask),
        "EMA": lambda: step.ema_phase(state, state.nimg + TRAIN_BATCH),
    }
    try:
        for det in (False, True):
            torch.use_deterministic_algorithms(det)
            for _ in range(2):
                step(state, data, gen, do_dr1=True)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = {k: [] for k in phases}
            for _ in range(PHASE_REPS):
                for name, fn in phases.items():
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    fn()
                    end.record()
                    torch.cuda.synchronize()
                    times[name].append(start.elapsed_time(end))
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            print(f"phase8 migan_places256 batch 32 step, "
                  f"{'deterministic' if det else 'default'} algorithms, "
                  f"median device ms per phase (CUDA events, {PHASE_REPS} "
                  f"steps after 2 warm-up steps): "
                  + ", ".join(f"{k} {statistics.median(v):.2f}"
                              for k, v in times.items())
                  + f"; peak device memory {peak:.2f} GiB ({gpu})",
                  flush=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(STEP_WINDOW):
                step(state, data, gen, do_dr1=False)
                torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    events = prof.events()
    win = next(e for e in events
               if e.name == STEP_WINDOW and e.device_type == DeviceType.CPU)
    lo, hi = win.time_range.start, win.time_range.end
    spans = [(e.time_range.start, e.time_range.end) for e in events
             if e.device_type == DeviceType.CUDA and e.name != STEP_WINDOW]
    check(bool(spans), "phase8: the profiler recorded no device events")
    busy = busy_union(spans, (lo, hi))
    print(f"phase8 one deterministic step (Gmain, Dmain, EMA) under "
          f"torch.profiler: device busy {busy / 1e3:.1f} ms of a "
          f"{(hi - lo) / 1e3:.1f} ms window = {100 * busy / (hi - lo):.1f}% "
          f"({len(spans)} device events; {gpu})", flush=True)
    del step, state, data
    torch.cuda.empty_cache()


def _write_teacher(tmp: str) -> str:
    """A seeded full-width Co-Mod-GAN-256 teacher (non-zero noise
    strengths) as the JAX package's `.npz`; returns its path."""
    from migan_tpu_torch.io import save_train_npz
    from migan_tpu_torch.models import comodgan

    t0 = time.perf_counter()
    teacher = comodgan.generator_init(comodgan.CoModGANConfig(resolution=256),
                                      torch.Generator().manual_seed(SEED + 9))
    with torch.no_grad():
        for name, p in teacher.named_parameters():
            if name.endswith("noise_strength"):
                p.fill_(0.1)
    n_teacher = sum(p.numel() for p in teacher.parameters())
    check(n_teacher == 79_177_378, f"teacher: {n_teacher:,} parameters")
    teacher_path = os.path.join(tmp, "comodgan_256_seeded.npz")
    save_train_npz(teacher_path, teacher)
    print(f"phase8 seeded Co-Mod-GAN-256 teacher: {n_teacher:,} parameters, "
          f"written in {time.perf_counter() - t0:.1f} s", flush=True)
    return teacher_path


def phase_train(tmp: str, gpu: str, results: dict) -> str:
    """`cli.train --experiment migan_places256` (full width, batch 32,
    the seeded full-width Co-Mod-GAN-256 teacher, R1) for 12 steps; a run
    SIGKILLed after its first checkpoint and resumed, held bit-equal to
    the uninterrupted one; one step on the card against the CPU; the
    phases' device times; the export CLI on the checkpoint."""
    import glob
    import signal

    import numpy as np

    from migan_tpu_torch.cli import export
    from migan_tpu_torch.models.registry import get_model
    from migan_tpu_torch.ops.kernels import (
        launch_counts, reset_launch_counts,
    )
    from migan_tpu_torch.train import checkpoint as ckpt
    from migan_tpu_torch.train import loop
    from migan_tpu_torch.train.train_step import init_train_state
    from migan_tpu_torch.utils.config import ConfigBanks

    # the training runs are processes of their own and need most of the
    # card: give back what the earlier phases cached
    torch.cuda.empty_cache()
    teacher_path = _write_teacher(tmp)

    # 1. the uninterrupted run
    root_a = os.path.join(tmp, "train_a")
    out_a = os.path.join(tmp, "train_a.log")
    t0 = time.perf_counter()
    proc, out = _train_process(_train_argv(teacher_path, root_a, "a"), out_a)
    _check_train_run(proc, out, out_a, "uninterrupted run")
    wall_a = time.perf_counter() - t0
    run_a = _run_dir(root_a)
    ticks = _tick_lines(out_a)
    for line in ticks:
        print(f"phase8 run a: {line}", flush=True)
    check(len(ticks) == TRAIN_STEPS // TICK_STEPS, f"phase8: {len(ticks)} "
          f"ticks")
    spk = [float(l.split("sec_per_kimg ")[1].split()[0]) for l in ticks]
    print(f"phase8 s/kimg from the tick lines: tick 0 (start-up included) "
          f"{spk[0]}, ticks 1-{len(spk) - 1} median "
          f"{statistics.median(spk[1:])} ({', '.join(map(str, spk[1:]))}); "
          f"{TRAIN_STEPS} steps in {wall_a:.1f} s wall, process start to "
          f"exit ({gpu})", flush=True)
    with open(os.path.join(run_a, "stats.jsonl")) as f:
        rows = [json.loads(l) for l in f]
    losses = {k: v["mean"] for r in rows for k, v in r.items()
              if k.startswith("Loss/")}
    check(all(np.isfinite(v) for v in losses.values()) and
          "Loss/r1_penalty" in losses and
          "Loss/G/kd_l1_image_level_loss" in losses,
          f"phase8: losses {losses}")
    final_a = ckpt.latest(os.path.join(run_a, "weight"))
    check(final_a.endswith(f"step_{TRAIN_STEPS:08d}"), f"phase8: {final_a}")
    state_a = ckpt.load(final_a)
    check(state_a["step"] == TRAIN_STEPS
          and state_a["nimg"] == TRAIN_STEPS * TRAIN_BATCH,
          f"phase8: step {state_a['step']} nimg {state_a['nimg']}")
    cfg = ConfigBanks("configs").experiment("migan_places256")
    init = init_train_state(torch.Generator().manual_seed(SEED),
                            get_model()(cfg["model_g"]).cfg,
                            get_model()(cfg["model_d"]).cfg,
                            loop._train_config_from_cfg(cfg["train"])
                            ).state_dict()
    moved = {k: bool(_state_equal(init[k], state_a[k]))
             for k in ("params_G", "params_D", "params_G_ema")}
    check(all(moved.values()), f"phase8: moved {moved}")
    print(f"phase8 run a: every loss finite over {TRAIN_STEPS} steps "
          + ", ".join(f"{k} {v:.4f}" for k, v in sorted(losses.items()))
          + f" (last tick's means); G, D and the EMA moved from their "
          f"initial values; G {_numel(state_a['params_G']):,} elements, "
          f"D {_numel(state_a['params_D']):,}", flush=True)

    # 2. killed after its first committed checkpoint, then resumed
    root_b = os.path.join(tmp, "train_b")
    out_b = os.path.join(tmp, "train_b.log")
    proc, out = _train_process(_train_argv(teacher_path, root_b, "b"), out_b)
    killed_at = None
    deadline = time.time() + 900
    while proc.poll() is None and time.time() < deadline:
        weight = glob.glob(os.path.join(root_b, "*", "weight"))
        if weight and ckpt.latest(weight[0]):
            proc.send_signal(signal.SIGKILL)
            killed_at = sorted(os.listdir(weight[0]))
            break
        time.sleep(0.05)
    proc.wait(timeout=60)
    out.close()
    check(killed_at is not None, "phase8: run b ended before its first "
          "checkpoint")
    run_b = _run_dir(root_b)
    resumed_from = ckpt.latest(os.path.join(run_b, "weight"))
    root_c = os.path.join(tmp, "train_c")
    out_c = os.path.join(tmp, "train_c.log")
    t0 = time.perf_counter()
    proc, out = _train_process(
        _train_argv(teacher_path, root_c, "c")
        + ["--resume-path", os.path.join(run_b, "weight")], out_c,
        launcher=_one_rank(tmp, "train_launcher", TRAIN_LAUNCHER))
    _check_train_run(proc, out, out_c, "resumed run")
    wall_c = time.perf_counter() - t0
    with open(out_c) as f:
        log_c = f.read()
    check(ONE_RANK_LINE in log_c, f"phase8 run c: no {ONE_RANK_LINE!r} "
          f"line\n{log_c[-2000:]}")
    final_c = ckpt.latest(os.path.join(_run_dir(root_c), "weight"))
    diff = _state_equal(state_a, ckpt.load(final_c))
    check(not diff, f"phase8: the resumed run differs from the "
          f"uninterrupted one at {diff[:10]}")
    print(f"phase8 run b SIGKILLed with {killed_at} on disk, resumed from "
          f"{os.path.basename(resumed_from)} to step {TRAIN_STEPS} as one "
          f"rank of torch.distributed.run ({ONE_RANK_LINE}; gradients "
          f"and stats through NCCL; {wall_c:.1f} s wall): its final state "
          f"(G, D, EMA, both Adam states, step, nimg) equals the "
          f"uninterrupted one-process run's bit for bit (deterministic "
          f"algorithms)", flush=True)

    # 3. one step on the card against the CPU; the phases' times
    _card_vs_cpu_step(teacher_path, gpu)
    _phase_times(teacher_path, gpu)

    # 4. the export CLI on the checkpoint's params_G_ema
    root = os.path.join(tmp, "train_export")
    _write_pairs(root, ((256, 256), (300, 200)), SEED + 400)
    reset_launch_counts()
    t0 = time.perf_counter()
    stats = export.main([
        "--model-path", os.path.join(run_a, "weight"), "--resolution", "256",
        "--origs-dir", os.path.join(root, "images"), "--masks-dir",
        os.path.join(root, "masks"), "--output-dir",
        os.path.join(root, "out"), "--num-samples", "2", "--device", "cuda"])
    torch.cuda.synchronize()
    counts = launch_counts()
    record_path(results, "train export", counts)
    want = {k: 2 * v for k, v in EXPECTED_LAUNCHES[256].items()}
    check(counts == want, f"phase8 export: launches {counts}, expected "
          f"{want}")
    check(stats["diff_pct"] < FOLD_DIFF_LIMIT
          and stats["chain_diff_pct"] < FOLD_DIFF_LIMIT,
          f"phase8 export: fold diff {stats}")
    print(f"phase8 export CLI on {os.path.basename(final_a)}'s "
          f"params_G_ema: Average diff {stats['diff_pct']:.6f}%, through "
          f"the kernel chain {stats['chain_diff_pct']:.6f}% (limit "
          f"{FOLD_DIFF_LIMIT}%), {time.perf_counter() - t0:.2f} s wall, "
          f"launches {counts}", flush=True)
    return teacher_path


# ---------------------------------------------------------------------------
# Phase 9: the published FFHQ training with its in-loop FID, on the card
# ---------------------------------------------------------------------------

FFHQ_RES = 256
# the zip: EVAL_ITEMS distinct images at the head of the val split (what
# the metric reads), filler entries (one small PNG's bytes, never read) up
# to the split at entry 10,000, then FFHQ_TRAIN_ITEMS distinct images for
# the train split
FFHQ_EVAL_ITEMS, FFHQ_SPLIT, FFHQ_TRAIN_ITEMS = 128, 10000, 64
FFHQ_TICK_STEPS = 4       # ticks of 4 steps, an evaluation at each from 1
FFHQ_EVALS = 2
FFHQ_STEPS = FFHQ_TICK_STEPS * (FFHQ_EVALS + 1)
FFHQ_METRIC = "fid10k_full_inpainting"
FFHQ_HOLD_ITEMS = 8       # card against CPU: the first 8 val items
MASK_RATE_N = {"native": 400, "pil": 100}


def _ffhq_zip(root: str, res: int, eval_items: int, train_items: int,
              seed: int) -> None:
    """`<root>/ffhq256x256.zip` (whatever `res`), entries named by a
    5-digit stem in a shuffled order: distinct seeded images (smooth
    colour fields plus noise) at stems [0, eval_items) and
    [FFHQ_SPLIT, FFHQ_SPLIT + train_items), a flat PNG at the others."""
    import io
    import zipfile

    import numpy as np
    from PIL import Image

    def png(img) -> bytes:
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG", compress_level=1)
        return buf.getvalue()

    def image(i: int):
        rng = np.random.RandomState(seed + i)
        low = Image.fromarray(rng.randint(0, 256, (8, 8, 3), np.uint8))
        smooth = np.asarray(low.resize((res, res), Image.BICUBIC), np.int16)
        noise = rng.randint(-12, 13, (res, res, 3))
        return np.clip(smooth + noise, 0, 255).astype(np.uint8)

    filler = png(np.full((res, res, 3), 128, np.uint8))
    distinct = set(range(eval_items)) | set(
        range(FFHQ_SPLIT, FFHQ_SPLIT + train_items))
    order = np.random.RandomState(seed).permutation(FFHQ_SPLIT + train_items)
    with zipfile.ZipFile(os.path.join(root, "ffhq256x256.zip"), "w",
                         zipfile.ZIP_STORED) as z:
        for i in order:
            z.writestr(f"{i // 1000:02d}000/{i:05d}.png",
                       png(image(int(i))) if i in distinct else filler)


def _ffhq_argv(root: str, teacher: str, detector: str, log_root: str,
               batch: int = 32) -> list:
    """The training CLI's arguments: migan_ffhq256 as published, with
    only the data, the teacher, native masks, the detector, the metric's
    item cap, an evaluation every tick and ticks of FFHQ_TICK_STEPS steps
    set; `batch`, the config's own, for the tick length."""
    return ["--max-steps", str(FFHQ_STEPS),
            "--set", f"train.dataset.root_dir={root}",
            "--set", f"eval.dataset.root_dir={root}",
            "--set", f"train.image_level_kd_kwargs.teacher1_path={teacher}",
            "--set", "train.dataset.formatter.args.mask_backend=native",
            "--set", f"eval.inception_weights={detector}",
            "--set", f"eval.max_items={FFHQ_EVAL_ITEMS}",
            "--set", "train.snapshot.evaluate=1",
            "--set", f"train.kimg_per_tick={FFHQ_TICK_STEPS * batch / 1000}",
            "--set", f"env.log_root_dir={log_root}"]


def _ffhq_run_checks(run_dir: str, log: str) -> dict:
    """The metric branch's records of a finished run: the detector's
    flavor, one metric line and one `Metrics/fid` line per evaluation,
    finite FIDs, one best checkpoint at the lowest FID, the dataset
    statistics computed once and read back at every later evaluation.
    Returns the FIDs, their steps, the evaluations' times and the best
    checkpoint's path."""
    import math

    check("training-time FID detector flavor: nvidia_tf" in log,
          "phase9: the nvidia_tf detector flavor is not in the log")
    with open(os.path.join(run_dir, f"metric-{FFHQ_METRIC}.jsonl")) as f:
        recs = [json.loads(l) for l in f]
    fids = [r["results"]["fid"] for r in recs]
    check(len(recs) == FFHQ_EVALS and all(
        math.isfinite(v) and v > 0 for v in fids),
        f"phase9: metric records {recs}")
    with open(os.path.join(run_dir, "stats.jsonl")) as f:
        logged = [r["Metrics/fid"] for r in map(json.loads, f)
                  if "Metrics/fid" in r]
    check(logged == fids, f"phase9: Metrics/fid in stats.jsonl {logged}, "
          f"metric records {fids}")
    steps = [FFHQ_TICK_STEPS * (t + 1) for t in range(1, FFHQ_EVALS + 1)]
    best_dir = os.path.join(run_dir, "weight", "best")
    best = sorted(d for d in os.listdir(best_dir) if d.startswith("step_"))
    want = steps[min(range(len(fids)), key=fids.__getitem__)]
    check(best == [f"step_{want:08d}"], f"phase9: weight/best holds {best}, "
          f"the lowest FID is step {want}'s ({fids})")
    cache = os.listdir(os.path.join(run_dir, "fid-cache"))
    check(len(cache) == 1, f"phase9: fid-cache holds {cache}")
    path = os.path.join(run_dir, "fid-cache", cache[0])
    computed = log.count(f"dataset feature stats computed, saved to {path}")
    read = log.count(f"dataset feature stats read from {path}")
    check(computed == 1 and read == FFHQ_EVALS - 1,
          f"phase9: dataset stats computed {computed} times, read "
          f"{read} times")
    return {"fids": fids, "steps": steps,
            "times": [r["total_time"] for r in recs],
            "best": os.path.join(best_dir, best[0])}


def _ffhq_hold(best: str, root: str, detector: str,
               experiment: str = "migan_ffhq256", config_root: str = "configs",
               devices=("cuda", "cpu"), items: int = FFHQ_HOLD_ITEMS) -> dict:
    """The best checkpoint's `params_G_ema` through
    `compute_feature_stats_for_inpainting` on the first `items` val items
    on each device, from the same global np.random seed (the val
    formatter draws its masks from it): each item's composite features,
    and its real image's."""
    import numpy as np

    from migan_tpu_torch.data.factory import get_dataset
    from migan_tpu_torch.evalx import inception, metrics
    from migan_tpu_torch.models import migan
    from migan_tpu_torch.models.registry import get_model
    from migan_tpu_torch.train import checkpoint as ckpt
    from migan_tpu_torch.utils.config import ConfigBanks

    cfg = ConfigBanks(config_root).experiment(experiment)
    cfg["eval"]["dataset"]["root_dir"] = root
    dataset = get_dataset(cfg["eval"]["dataset"])
    g_cfg = get_model()(cfg["model_g"]).cfg
    state = ckpt.extract_field(best)
    det_model, flavor = inception.load_inception_weights(detector)
    out = {}
    for dev in devices:
        G = migan.Generator(g_cfg)
        G.load_state_dict(state)
        G.to(dev).eval().requires_grad_(False)
        det = inception.make_detector(det_model.to(dev), flavor)
        feats = []

        def capture(x):
            feats.append(det(x))
            return feats[-1]

        np.random.seed(SEED)
        metrics.compute_feature_stats_for_inpainting(
            dataset, lambda x: migan.generator_apply(G, x,
                                                     noise_mode="const"),
            capture, batch_size=items, max_items=items, device=dev)
        np.random.seed(SEED)
        metrics.compute_feature_stats_for_dataset(
            dataset, capture, flavor, batch_size=items, max_items=items,
            device=dev)
        out[dev] = [f.double().cpu().numpy() for f in feats]
    return out


def _mask_rates(res: int) -> dict:
    """Host masks/s at `res` on this thread: the native rasterizer (built
    first, not timed) and the PIL generator, seeded masks, hole range
    (0, 1)."""
    import numpy as np

    from migan_tpu_torch.data.fast_masks import fast_random_mask, load_library
    from migan_tpu_torch.data.masks import RandomMask

    load_library()
    rates = {}
    for name, fn in (("native", lambda i: fast_random_mask(
                        res, (0.0, 1.0), seed=i)),
                     ("pil", lambda i: RandomMask(
                        res, (0.0, 1.0), rng=np.random.RandomState(i)))):
        n = MASK_RATE_N[name]
        t0 = time.perf_counter()
        for i in range(n):
            fn(i)
        rates[name] = n / (time.perf_counter() - t0)
    return rates


def phase_ffhq(tmp: str, gpu: str, teacher_path: str) -> None:
    """`cli.train --experiment migan_ffhq256` (full width, batch 32, the
    config's losses and KD, native masks) on a seeded zip with two in-loop
    FID evaluations on a seeded NVIDIA TF-named detector; the metric
    branch's records; the best checkpoint's features on the card against
    the CPU; host mask rates."""
    import subprocess

    import numpy as np

    from migan_tpu_torch.evalx import inception

    root = os.path.join(tmp, "ffhq")
    os.makedirs(root)
    t0 = time.perf_counter()
    _ffhq_zip(root, FFHQ_RES, FFHQ_EVAL_ITEMS, FFHQ_TRAIN_ITEMS, SEED + 90)
    detector = os.path.join(tmp, "inception-2015-12-05.pt")
    torch.save(inception.seeded_state_dict(SEED + 91, flavor="nvidia_tf"),
               detector)
    print(f"phase9 seeded ffhq256x256.zip ({FFHQ_SPLIT + FFHQ_TRAIN_ITEMS} "
          f"entries, {FFHQ_EVAL_ITEMS} + {FFHQ_TRAIN_ITEMS} distinct, "
          f"{os.path.getsize(os.path.join(root, 'ffhq256x256.zip')) / 2**20:.1f}"
          f" MiB) and TF-named detector written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    log_root = os.path.join(tmp, "train_ffhq")
    out_path = os.path.join(tmp, "train_ffhq.log")
    t0 = time.perf_counter()
    with open(out_path, "w") as out:
        proc = subprocess.run(
            [sys.executable, "-m", "migan_tpu_torch.cli.train",
             "--experiment", "migan_ffhq256",
             *_ffhq_argv(root, teacher_path, detector, log_root)],
            cwd=os.path.dirname(os.path.abspath(__file__)), stdout=out,
            stderr=subprocess.STDOUT, text=True, timeout=900)
    wall = time.perf_counter() - t0
    with open(out_path) as f:
        log = f.read()
    check(proc.returncode == 0,
          f"phase9: exit {proc.returncode}\n{log[-4000:]}")
    run = _run_dir(log_root)
    got = _ffhq_run_checks(run, log)
    ticks = [l for l in _tick_lines(out_path) if "sec_per_kimg" in l]
    for line in ticks:
        print(f"phase9 {line}", flush=True)
    spk = [float(l.split("sec_per_kimg ")[1].split()[0]) for l in ticks]
    devmem = max(float(l.split("devmem ")[1].split("g")[0]) for l in ticks)
    print(f"phase9 s/kimg from the tick lines: tick 0 (start-up included) "
          f"{spk[0]}, ticks 1-{len(spk) - 1} {', '.join(map(str, spk[1:]))}"
          f" (evaluations not included); peak device memory {devmem:.2f} "
          f"GiB (the last tick's devmem); {FFHQ_STEPS} steps and "
          f"{FFHQ_EVALS} evaluations in {wall:.1f} s wall, process start to "
          f"exit ({gpu})", flush=True)
    splits = [l.split("fid time split: ")[1] for l in log.splitlines()
              if "fid time split: " in l]
    check(len(splits) == FFHQ_EVALS, f"phase9: time splits {splits}")
    for step, fid, sec, split in zip(got["steps"], got["fids"],
                                     got["times"], splits):
        print(f"phase9 {FFHQ_METRIC} after step {step} "
              f"({FFHQ_EVAL_ITEMS} items, nvidia_tf detector): FID "
              f"{fid:.6f}, total_time {sec:.2f} s; {split} (host wall, "
              f"{os.cpu_count()} host cores; {gpu})", flush=True)
    print(f"phase9 weight/best: {os.path.basename(got['best'])}, the lowest "
          f"FID; fid-cache: one file, computed at the first evaluation and "
          f"read at the second", flush=True)
    feats = _ffhq_hold(got["best"], root, detector)
    card, cpu = feats["cuda"], feats["cpu"]
    rel = [np.linalg.norm(a - b, axis=1) / np.linalg.norm(b, axis=1)
           for a, b in zip(card, cpu)]
    fake_rel, real_rel = rel[0].max(), rel[1].max()
    moved = (np.linalg.norm(card[0] - card[1], axis=1)
             / np.linalg.norm(card[1], axis=1))
    print(f"phase9 card vs CPU, {os.path.basename(got['best'])}'s "
          f"params_G_ema through compute_feature_stats_for_inpainting "
          f"({FFHQ_HOLD_ITEMS} val items, same global seed): composite "
          f"features relative L2 max {fake_rel:.3e}, real images' "
          f"{real_rel:.3e} (limit {EVAL_ACTS_RTOL}); composites move their "
          f"features from the real image's by {moved.min():.3e} at least "
          f"(median {np.median(moved):.3e})", flush=True)
    check(max(fake_rel, real_rel) <= EVAL_ACTS_RTOL,
          "phase9: card features differ from CPU")

    rates = _mask_rates(FFHQ_RES)
    print(f"phase9 host masks at {FFHQ_RES} on one thread: native "
          f"{rates['native']:.1f}/s, PIL {rates['pil']:.1f}/s, "
          f"{rates['native'] / rates['pil']:.1f}x ({os.cpu_count()} host "
          f"cores; {gpu})", flush=True)


def _numel(state_dict: dict) -> int:
    return sum(v.numel() for v in state_dict.values())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # cuBLAS's deterministic workspace, read at its first use: phase 8
    # times a training step with deterministic algorithms
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    t0 = time.perf_counter()

    def took(phase: int) -> None:
        print(f"phase{phase} done at {time.perf_counter() - t0:.1f} s",
              flush=True)

    phase_kernels(results)
    took(1)
    with tempfile.TemporaryDirectory() as tmp:
        forwards = phase_generator(tmp, results)
        took(2)
        phase_demo(tmp, results)
        took(3)
        phase_times(forwards, gpu)
        took(4)
        phase_serve(forwards[512, "float32"][0], tmp, gpu, results)
        took(5)
        phase_evaluate(tmp, gpu, results)
        took(6)
        phase_export(tmp, gpu, results)
        took(7)
        teacher = phase_train(tmp, gpu, results)
        took(8)
        phase_ffhq(tmp, gpu, teacher)
        took(9)

    print(gpu)
    print(json.dumps({"kernels": [results[k] for k in SOURCES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
