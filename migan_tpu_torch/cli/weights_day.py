"""One-command parity check for the day published MI-GAN weights arrive,
on the port (port of `scripts/weights_day.py`): import -> the four-suite
demo against the reference's committed result images -> optional golden
regeneration -> FID/LPIPS against published numbers -> pass/fail report.

    python -m migan_tpu_torch.cli.weights_day --weights-dir weights/ \
        [--real-dir data/Places2/val_512] \
        [--expect-fid 0.93 --expect-lpips 0.144] [--regen-goldens] \
        [--device cuda]

Dry run (no weights needed; random weights through the real `.pt` import
path, the parity legs reported as EXPECTED-FAIL):

    python -m migan_tpu_torch.cli.weights_day --dry-run --out wd/ \
        [--device cpu]

Artifacts searched in --weights-dir (reference README.md:24-55):
  migan_256_places2*.pt, migan_512_places2*.pt, migan_256_ffhq*.pt,
  pt_inception*.pth / inception*.pt, *alex*.pth (LPIPS),
  comodgan_*_places2*.pt (teacher; only needed for the KD sanity hint).

The demo and evaluation legs run `python -m migan_tpu_torch.cli.demo` and
`.evaluate` with `--device` passed through. The suites' images, masks and
result images are read from the reference repository's `examples/`
directory, named by `--reference-examples`; without it the demo legs (and
a dry run's evaluation, which reads its images there) are SKIP. A suite
the directory lacks is reported as the JAX script reports it.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# suite -> (reference example dir, model name, weight key, extra flags)
SUITES = [
    ("ffhq_256_freeform", "migan-256", "migan_256_ffhq", []),
    ("places2_256_freeform", "migan-256", "migan_256_places2", []),
    ("places2_512_freeform", "migan-512", "migan_512_places2", []),
    ("places2_512_object", "migan-512", "migan_512_places2",
     ["--invert-mask"]),
]

WEIGHT_PATTERNS = {
    "migan_256_places2": ["migan*256*places*"],
    "migan_512_places2": ["migan*512*places*"],
    "migan_256_ffhq": ["migan*256*ffhq*", "migan*ffhq*256*"],
    "inception": ["pt_inception*", "*inception*"],
    "lpips": ["*alex*", "*lpips*"],
    "comodgan_256_places2": ["comodgan*256*"],
    "comodgan_512_places2": ["comodgan*512*"],
}
DRY_RUN_MODELS = (("migan_256_ffhq", 256), ("migan_256_places2", 256),
                  ("migan_512_places2", 512))


def find_artifacts(weights_dir):
    found = {}
    for key, pats in WEIGHT_PATTERNS.items():
        for pat in pats:
            hits = sorted(glob.glob(os.path.join(weights_dir, pat)))
            if hits:
                found[key] = hits[0]
                break
    return found


def make_dry_run_weights(out_dir, seed: int = 0):
    """Random generators (from a `torch.Generator` seeded with `seed`, one
    per model) saved as reference-layout `.pt` state_dicts
    (`io.export_migan_inference`), so that the dry run drives the same
    `.pt` import leg real weights will."""
    import torch

    from ..io import export_migan_inference
    from ..models.migan_inference import GeneratorConfig, generator_init

    os.makedirs(out_dir, exist_ok=True)
    made = {}
    for key, res in DRY_RUN_MODELS:
        g = generator_init(GeneratorConfig(resolution=res),
                           torch.Generator().manual_seed(seed))
        path = os.path.join(out_dir, f"{key}.pt")
        torch.save(export_migan_inference(g), path)
        made[key] = path
    return made


def run(cmd, log_path, env=None):
    with open(log_path, "at") as f:
        f.write(f"\n$ {' '.join(cmd)}\n")
        f.flush()
        t0 = time.time()
        p = subprocess.run(cmd, stdout=f, stderr=subprocess.STDOUT,
                           cwd=REPO, env=env)
        f.write(f"[rc={p.returncode} in {time.time() - t0:.1f}s]\n")
    return p.returncode


def leg_demo_suites(art, args, log):
    """Demo every suite and diff against the reference's committed result
    images (reference README.md:56-86 goldens)."""
    results = []
    for suite, model, wkey, flags in SUITES:
        if args.reference_examples is None:
            results.append((suite, "SKIP", "no --reference-examples given"))
            continue
        if wkey not in art:
            results.append((suite, "SKIP", f"no {wkey} weight"))
            continue
        sdir = os.path.join(args.reference_examples, suite)
        odir = os.path.join(args.out, f"demo_{suite}")
        rc = run([sys.executable, "-m", "migan_tpu_torch.cli.demo",
                  "--model-name", model, "--model-path", art[wkey],
                  "--images-dir", os.path.join(sdir, "images"),
                  "--masks-dir", os.path.join(sdir, "masks"),
                  "--output-dir", odir, "--device", args.device, *flags],
                 log)
        if rc != 0:
            results.append((suite, "FAIL", f"demo rc={rc}"))
            continue
        gdir = os.path.join(sdir, "results", "migan")
        if not os.path.isdir(gdir):
            results.append((suite, "SKIP", "no reference results dir"))
            continue
        from PIL import Image

        worst = -1
        n = 0
        for g in sorted(glob.glob(os.path.join(gdir, "*.png"))):
            ours = os.path.join(odir, os.path.basename(g))
            if not os.path.isfile(ours):
                continue
            a = np.asarray(Image.open(g), np.int16)
            b = np.asarray(Image.open(ours), np.int16)
            if a.shape != b.shape:
                worst = 255
                continue
            worst = max(worst, int(np.abs(a - b).max()))
            n += 1
        ok = 0 <= worst <= args.demo_tol
        results.append((suite, "PASS" if ok else "FAIL",
                        f"max|diff|={worst} over {n} imgs "
                        f"(tol {args.demo_tol})"))
    return results


def leg_eval(art, args, log):
    cmd = [sys.executable, "-m", "migan_tpu_torch.cli.evaluate",
           "--model-name", "migan-512" if "migan_512_places2" in art
           else "migan-256",
           "--model-path", art.get("migan_512_places2")
           or art.get("migan_256_places2") or art.get("migan_256_ffhq"),
           "--real-dir", args.real_dir,
           "--batch-size", str(args.eval_batch_size),
           "--max-items", str(args.max_items), "--device", args.device]
    if "inception" in art:
        cmd += ["--inception-weights", art["inception"]]
    if "lpips" in art:
        cmd += ["--lpips-weights", art["lpips"]]
    if "inception" not in art or "lpips" not in art:
        cmd += ["--allow-random-detector"]
    ev_log = os.path.join(args.out, "evaluate.log")
    rc = run(cmd, ev_log)
    if rc != 0:
        return [("eval-run", "FAIL", f"evaluate rc={rc}, see {ev_log}")]
    fid = lpips = None
    with open(ev_log) as f:
        for line in f:
            if line.startswith("FID:"):
                fid = float(line.split()[-1])
            if line.startswith("LPIPS:"):
                lpips = float(line.split()[-1])
    out = [("eval-run", "PASS", f"FID={fid} LPIPS={lpips} "
            f"({args.max_items} items)")]
    for name, got, want in (("fid", fid, args.expect_fid),
                            ("lpips", lpips, args.expect_lpips)):
        if want is None:
            out.append((f"eval-{name}-parity", "SKIP",
                        f"no --expect-{name} given"))
        elif got is None:
            out.append((f"eval-{name}-parity", "FAIL", "metric not printed"))
        else:
            rel = abs(got - want) / max(abs(want), 1e-9)
            out.append((f"eval-{name}-parity",
                        "PASS" if rel < 0.01 else "FAIL",
                        f"got {got:.4f} want {want:.4f} (rel {rel:.2%})"))
    return out


def leg_regen_goldens():
    """The port's golden test (`tests/test_torch_golden.py`) holds the
    port's demo against `tests/goldens/`, which the JAX package's demo
    writes (`MIGAN_TPU_REGEN_GOLDENS=1 pytest
    tests/test_golden_regression.py`); it has no regeneration mode of its
    own, and this tool does not rewrite the JAX package's goldens."""
    return [("golden-regen", "SKIP", "tests/test_torch_golden.py has no "
             "regen mode: tests/goldens/* are the JAX package's, "
             "regenerated by scripts/weights_day.py --regen-goldens")]


def get_args(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--weights-dir", default=os.path.join(REPO, "weights"))
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "weights_day"))
    ap.add_argument("--dry-run", action="store_true",
                    help="generate random-weight .pt artifacts and drive "
                    "every leg (parity legs become EXPECTED-FAIL)")
    ap.add_argument("--real-dir", default=None,
                    help="validation image dir for the FID/LPIPS leg "
                    "(default: the 512 example images in dry runs)")
    ap.add_argument("--max-items", type=int, default=10000,
                    help="eval protocol size (reference uses 10k; dry run "
                    "forces a handful)")
    ap.add_argument("--eval-batch-size", type=int, default=64)
    ap.add_argument("--expect-fid", type=float, default=None,
                    help="published reference FID to match within 1%%")
    ap.add_argument("--expect-lpips", type=float, default=None)
    ap.add_argument("--demo-tol", type=int, default=2,
                    help="max uint8 diff vs reference demo goldens")
    ap.add_argument("--regen-goldens", action="store_true",
                    help="the golden regeneration leg (SKIP on the port: "
                    "the goldens are the JAX package's)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the demo and evaluation legs; "
                    "'cuda' fails them when no card is present")
    ap.add_argument("--reference-examples", default=None,
                    help="the reference repository's examples/ directory "
                    "(suite/{images,masks,results/migan}); without it the "
                    "demo legs are SKIP")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = get_args(argv)
    os.makedirs(args.out, exist_ok=True)
    log = os.path.join(args.out, "weights_day.log")
    report = []

    if args.dry_run:
        art = make_dry_run_weights(os.path.join(args.out, "dry_weights"))
        args.max_items = min(args.max_items, 4)
        args.eval_batch_size = min(args.eval_batch_size, 2)
        if args.real_dir is None and args.reference_examples is not None:
            args.real_dir = os.path.join(args.reference_examples,
                                         "places2_512_freeform", "images")
    else:
        art = find_artifacts(args.weights_dir)
        if args.real_dir is None and "migan_512_places2" in art:
            print("WARNING: no --real-dir; skipping the FID/LPIPS leg")
    for key in WEIGHT_PATTERNS:
        report.append((f"artifact-{key}",
                       "FOUND" if key in art else "MISSING",
                       art.get(key, "")))

    report += leg_demo_suites(art, args, log)
    if args.real_dir:
        report += leg_eval(art, args, log)
    elif args.dry_run:
        report.append(("eval-run", "SKIP", "no --real-dir or "
                       "--reference-examples given"))
    if args.regen_goldens:
        report += leg_regen_goldens()
    else:
        report.append(("golden-regen", "SKIP", "pass --regen-goldens "
                       "(real weights only)"))
    if "comodgan_256_places2" in art or "comodgan_512_places2" in art:
        report.append(("kd-teacher", "HINT",
                       "run docs/REAL_WEIGHTS.md §5 for the KD sanity leg"))

    # ---- report ----------------------------------------------------------
    hard_fail = False
    print("\n=== weights-day report ===")
    for name, status, detail in report:
        if status == "FAIL" and args.dry_run and (
                name.startswith(("ffhq", "places2", "eval-"))):
            status = "EXPECTED-FAIL(dry)"
        if status == "FAIL" or (status == "MISSING" and not args.dry_run
                                and name.startswith("artifact-migan")):
            hard_fail = True
        print(f"  {name:32s} {status:18s} {detail}")
    with open(os.path.join(args.out, "report.json"), "wt") as f:
        json.dump([{"leg": n, "status": s, "detail": d}
                   for n, s, d in report], f, indent=1)
    print(f"logs: {log}\nreport: {args.out}/report.json")
    print("RESULT:", "FAIL" if hard_fail else "PASS")
    return 1 if hard_fail else 0


if __name__ == "__main__":
    sys.exit(main())
