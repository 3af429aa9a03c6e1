"""A/B of the up-2 FIR of a synthesis level: in the upblock kernel's
stencil, or folded into the pointwise conv before it (port of
`scripts/bench_fir_fold.py`).

    python -m migan_tpu_torch.cli.fir_fold
    python -m migan_tpu_torch.cli.fir_fold --device cpu

At each of the two top synthesis levels of migan-512 that have a
pointwise conv before their upblock (the port's unfolded widths, from
`models/migan_kernels.kernel_shapes`), from seeded inputs: y, the output
of conv1's depthwise stage and activation [N, Hl, Wl, Ci], its pointwise
weights [Ci, C], and the upblock's skip, noise and weights. Chain A is
the main path's order: the 1x1 conv as one matrix product, then
`fused_up_block` with the FIR in its stencil. Chain B folds the FIR into
the conv (`ops/conv.py::pw_up2_phase`, four phase-weighted 2x2 convs)
and runs `fused_up_block(phase_input=True)`, which only interleaves the
phases; B2 makes the phases with one 3x3 conv. B and B2 are held
against A on the same inputs before anything is timed (float32 atol and
rtol 1e-4; bfloat16 atol 0.05 + rtol 0.02), then each chain and each
piece is timed with CUDA events after warm-up, float32 (TF32 off) and
bfloat16. Prints the card's name and power limit, then one JSON line per
level and dtype with the JAX script's keys.

The batch is 32, the JAX script's 16 folded pairs. On the CPU
(`--device cpu`, for the tests) the wrappers run their plain versions
at a small size (migan-128 with ch_base 1024, batch 1): the checks run
and the times are null (not measured). The default device is the card;
without one it exits 1.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..models.migan_inference import GeneratorConfig
from ..models.migan_kernels import kernel_shapes
from ..ops.conv import pw_up2_phase
from ..ops.kernels import fused_up_block

SEED = 0
LEVELS = 2         # the JAX script's two geometries
BATCH = 32         # the JAX script's 16 folded pairs
CONFIG = GeneratorConfig(resolution=512)
CPU_CONFIG, CPU_BATCH = GeneratorConfig(resolution=128, ch_base=1024), 1
WARMUP, REPS = 2, 10
KEYS = ("pw_only_ms", "phaseconv_only_ms", "phaseconv_packed_only_ms",
        "C_kernel_only_stencil_ms", "D_kernel_only_slice_ms",
        "A_pw_plus_stencil_kernel_ms", "B_phaseconv_plus_slice_kernel_ms",
        "B2_packedconv_variant_ms")
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (5e-2, 2e-2)}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def geometries(cfg: GeneratorConfig) -> list:
    """The top LEVELS synthesis kernel levels whose upblock follows a
    pointwise conv (a sepconv with final_act=False): {name, Hl, Wl, Ci,
    C, O}, top first."""
    shapes = kernel_shapes(cfg)
    out = []
    for prev, cur in zip(shapes, shapes[1:]):
        if prev[0] == "sepconv" and prev[5] is False and cur[0] == "upblock":
            _, hl, wl, ci, c, _ = prev
            out.append({"name": f"b{2 * hl}", "Hl": hl, "Wl": wl, "Ci": ci,
                        "C": c, "O": cur[4]})
    return out[::-1][:LEVELS]


def inputs(geo: dict, n: int, dtype, device) -> dict:
    """Seeded inputs of one level, made on `device` (scales as the JAX
    script's)."""
    gen = torch.Generator(device).manual_seed(SEED + geo["Hl"])
    hl, wl, ci, c, o = (geo[k] for k in ("Hl", "Wl", "Ci", "C", "O"))

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=device)
                * scale).to(dtype)

    return {"y": r(n, hl, wl, ci), "w_pw1": r(ci, c, scale=0.1),
            "skip": r(n, 2 * hl, 2 * wl, c),
            "noise_up": r(2 * hl, 2 * wl, scale=0.1),
            "w_dw": r(3, 3, c, scale=0.1), "b_dw": r(c, scale=0.1),
            "w_pw": r(c, o, scale=0.1), "noise2": r(2 * hl, 2 * wl,
                                                    scale=0.1)}


def pieces(t: dict) -> dict:
    """{key: the call it times} over the inputs `t`."""
    n, hl, wl, ci = t["y"].shape
    c = t["w_pw1"].shape[1]

    def pw(y):
        return (y.reshape(-1, ci) @ t["w_pw1"]).reshape(n, hl, wl, c)

    def up(x, phase_input=False):
        return fused_up_block(x, t["skip"], t["noise_up"], t["w_dw"],
                              t["b_dw"], t["w_pw"], t["noise2"],
                              phase_input=phase_input)

    x_lo = pw(t["y"])
    x4 = pw_up2_phase(t["y"], t["w_pw1"])
    y = t["y"]
    return {
        "pw_only_ms": lambda: pw(y),
        "phaseconv_only_ms": lambda: pw_up2_phase(y, t["w_pw1"]),
        "phaseconv_packed_only_ms":
            lambda: pw_up2_phase(y, t["w_pw1"], packed=True),
        "C_kernel_only_stencil_ms": lambda: up(x_lo),
        "D_kernel_only_slice_ms": lambda: up(x4, True),
        "A_pw_plus_stencil_kernel_ms": lambda: up(pw(y)),
        "B_phaseconv_plus_slice_kernel_ms":
            lambda: up(pw_up2_phase(y, t["w_pw1"]), True),
        "B2_packedconv_variant_ms":
            lambda: up(pw_up2_phase(y, t["w_pw1"], packed=True), True),
    }


def held(got: torch.Tensor, want: torch.Tensor, dtype, what: str) -> float:
    """max |got - want|; raises beyond the dtype's tolerance."""
    atol, rtol = TOL[dtype]
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"{what}: non-finite output")
    err = (got - want).abs()
    bad = int((err > atol + rtol * want.abs()).sum())
    if bad:
        raise RuntimeError(f"{what}: {bad} elements beyond atol {atol} "
                           f"rtol {rtol} (max |diff| {err.max().item():.3e})")
    return err.max().item()


def device_ms(fn, device: torch.device):
    """Mean device ms of fn() over REPS calls after WARMUP (CUDA events);
    None on the CPU, where nothing is timed."""
    if device.type != "cuda":
        return None
    for _ in range(WARMUP):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def run_level(geo: dict, n: int, dtype, device) -> dict:
    t = inputs(geo, n, dtype, device)
    p = pieces(t)
    what = f"{geo['name']} {str(dtype)[6:]}"
    a = p["A_pw_plus_stencil_kernel_ms"]()
    out = {"geometry": {"name": geo["name"], "N": n,
                        **{k: geo[k] for k in ("Hl", "Wl", "Ci", "C", "O")}},
           "dtype": str(dtype)[6:]}
    for key, label in (("B_phaseconv_plus_slice_kernel_ms", "B"),
                       ("B2_packedconv_variant_ms", "B2")):
        out[f"{label}_vs_A_max_abs_diff"] = held(p[key](), a, dtype,
                                                 f"{what}: {label} vs A")
    del a
    for key in KEYS:
        out[key] = device_ms(p[key], device)
    return out


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def run(device: str = "cuda") -> list:
    """One result per level and dtype, each printed as a JSON line."""
    device = torch.device(device)
    cfg, batch = CONFIG, BATCH
    if device.type == "cpu":
        cfg, batch = CPU_CONFIG, CPU_BATCH
    else:
        from .trace import card

        # float32 means IEEE float32 in the convs and the product
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        print(card(), flush=True)
    results = []
    for geo in geometries(cfg):
        for name, dtype in DTYPES.items():
            r = run_level(geo, batch, dtype, device)
            r["device"] = (torch.cuda.get_device_name(device)
                           if device.type == "cuda" else "cpu")
            print(json.dumps(r), flush=True)
            results.append(r)
    return results


def main(argv=None) -> int:
    args = get_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("fir_fold: no CUDA device (pass --device cpu to run the "
              "plain versions)", file=sys.stderr)
        return 1
    run(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
