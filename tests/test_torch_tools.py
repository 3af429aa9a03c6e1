"""The port's counterparts of two JAX-package scripts, and the training
report the port's runs share with the JAX package's, on the CPU:

  - `cli/eval_profile.py` (`scripts/bench_eval_profile.py`): its
    `profile` at batch 1, 64 px, one timed call and no warm-up returns
    every key of the JAX script, each time finite and positive;
  - `cli/weights_day.py` (`scripts/weights_day.py`): the dry run on the
    CPU exits 0 and writes `report.json` with every leg; its `.pt` files
    load through `load_pt` into the generators that wrote them (the same
    forward, bit for bit); `io.export_migan_inference` is the exact
    inverse of `load_pt` (a state_dict round trip is bit-equal) and
    equals the JAX package's `export_migan_inference` key for key and
    value for value on weights carried across; without
    `--reference-examples` the demo and evaluation legs are SKIP;
  - `scripts/training_demo_report.py` (it imports only matplotlib and
    PIL, so it needs no port): on a `stats.jsonl` and two
    `fakes*_combined.png` sheets in the format the port's `train/loop.py`
    writes them, it writes `curves.png` and the first and last sheets,
    downscaled to fit 1024 px.
"""

import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from migan_tpu.io.torch_import import export_migan_inference as j_export
from migan_tpu.models import migan_inference as jmi
from migan_tpu_torch.cli import eval_profile, weights_day
from migan_tpu_torch.io import export_migan_inference, load_npz, load_pt
from migan_tpu_torch.models.migan_inference import (
    GeneratorConfig, generator_apply, generator_init,
)
from test_torch_generator import _with_noise


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The gate runs 6 test workers on one host: torch's default of one
    thread per core in each of them oversubscribes it several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# scripts/bench_eval_profile.py's keys
JAX_EVAL_PROFILE_KEYS = (
    [f"{n}_{u}" for n in ("full_baseline", "full_batched_det",
                          "full_bf16_det", "full_batched_bf16")
     for u in ("ms", "imgs_per_sec")]
    + ["G_ms", "composite_ms", "resize_ms", "resize_bf16_ms"]
    + [f"{p}_{t}_ms" for t in ("f32", "bf16")
       for p in ("inception", "inception2n", "lpips")])


def test_eval_profile_returns_every_key():
    out = eval_profile.profile(1, res=64, iters=1, warmup=0, device="cpu")
    assert out["bs"] == 1 and out["device"] == "cpu"
    assert set(eval_profile.KEYS) == set(JAX_EVAL_PROFILE_KEYS)
    for key in JAX_EVAL_PROFILE_KEYS:
        assert math.isfinite(out[key]) and out[key] > 0, (key, out[key])


@pytest.fixture(scope="module")
def dry_run(tmp_path_factory):
    """The dry run on the CPU with one suite's examples present (one
    image and mask, and a result image the demo cannot match) and the
    others absent."""
    root = tmp_path_factory.mktemp("wd")
    suite = root / "examples" / "ffhq_256_freeform"
    rng = np.random.RandomState(0)
    for sub in ("images", "masks", "results/migan"):
        os.makedirs(suite / sub)
    Image.fromarray(rng.randint(0, 256, (256, 256, 3), np.uint8)).save(
        suite / "images" / "1.png")
    mask = np.full((256, 256), 255, np.uint8)
    mask[64:192, 64:192] = 0
    Image.fromarray(mask).save(suite / "masks" / "1.png")
    Image.fromarray(np.zeros((256, 256, 3), np.uint8)).save(
        suite / "results" / "migan" / "1.png")
    out = root / "out"
    rc = weights_day.main(["--dry-run", "--out", str(out), "--device", "cpu",
                           "--reference-examples", str(root / "examples")])
    with open(out / "report.json") as f:
        report = {r["leg"]: r for r in json.load(f)}
    return rc, report, out


def test_weights_day_dry_run_report(dry_run):
    rc, report, out = dry_run
    assert rc == 0
    legs = ([f"artifact-{k}" for k in weights_day.WEIGHT_PATTERNS]
            + [s for s, *_ in weights_day.SUITES]
            + ["eval-run", "golden-regen"])
    assert list(report) == legs
    for key, _ in weights_day.DRY_RUN_MODELS:
        assert report[f"artifact-{key}"]["status"] == "FOUND"
    # the one suite present ran the demo and was compared: the random
    # weights miss the result image (EXPECTED-FAIL(dry) in the printout)
    assert report["ffhq_256_freeform"]["status"] == "FAIL"
    assert "over 1 imgs" in report["ffhq_256_freeform"]["detail"]
    assert os.path.isfile(out / "demo_ffhq_256_freeform" / "1.png")
    for suite, *_ in weights_day.SUITES[1:]:
        assert report[suite]["status"] == "SKIP", report[suite]
    assert report["eval-run"]["status"] == "FAIL"    # no real images


def test_weights_day_skips_the_suites_without_reference_examples(
        tmp_path, monkeypatch):
    """No default outside the checkout: without `--reference-examples` the
    demo legs and the dry run's evaluation are SKIP, and nothing is run."""
    monkeypatch.setattr(weights_day, "make_dry_run_weights",
                        lambda out_dir: {})
    monkeypatch.setattr(weights_day, "run", None)     # no child process
    rc = weights_day.main(["--dry-run", "--out", str(tmp_path),
                           "--device", "cpu"])
    with open(tmp_path / "report.json") as f:
        report = {r["leg"]: r for r in json.load(f)}
    assert rc == 0
    for suite, *_ in weights_day.SUITES:
        assert report[suite] == {"leg": suite, "status": "SKIP",
                                 "detail": "no --reference-examples given"}
    assert report["eval-run"]["status"] == "SKIP"


def test_weights_day_pt_files_load_into_their_generators(dry_run):
    _, report, _ = dry_run
    x = torch.from_numpy(
        np.random.RandomState(1).randn(1, 256, 256, 4).astype(np.float32))
    for key, res in weights_day.DRY_RUN_MODELS:
        path = report[f"artifact-{key}"]["detail"]
        got = load_pt(torch.load(path, weights_only=True))
        want = generator_init(GeneratorConfig(resolution=res),
                              torch.Generator().manual_seed(0))
        assert got.cfg == want.cfg
        for (k, a), (k2, b) in zip(got.state_dict().items(),
                                   want.state_dict().items()):
            assert k == k2 and torch.equal(a, b), k
        assert torch.equal(generator_apply(got, x[:, :res, :res]),
                           generator_apply(want, x[:, :res, :res]))


def test_export_migan_inference_inverts_load_pt_and_matches_jax(tmp_path):
    from migan_tpu.io.checkpoint import save_npz as j_save_npz

    cfg = jmi.GeneratorConfig(resolution=32, ch_base=1024)
    params = _with_noise(jmi.generator_init(jax.random.PRNGKey(0), cfg),
                         np.random.RandomState(3))
    j_save_npz(str(tmp_path / "w.npz"), params)
    g = load_npz(str(tmp_path / "w.npz"),
                 GeneratorConfig(resolution=32, ch_base=1024))
    sd = export_migan_inference(g)
    want = j_export(params)
    assert sorted(sd) == sorted(want)
    for k, v in want.items():
        assert sd[k].dtype == torch.float32
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(v), k)
    back = export_migan_inference(
        load_pt(sd, GeneratorConfig(resolution=32, ch_base=1024)))
    assert list(back) == list(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)


def test_training_report_writes_curves_and_sheets(tmp_path):
    log = tmp_path / "run"
    os.makedirs(log)
    rows = []
    for tick in range(3):
        row = {"tick": tick, "kimg": 0.064 * (tick + 1),
               "sec_per_kimg": 12.5 + tick,
               "Loss/G/loss": {"num": 2, "mean": 1.0 - 0.1 * tick,
                               "std": 0.1},
               "Loss/D/loss": {"num": 2, "mean": 0.6, "std": 0.1},
               "Loss/scores/real": {"num": 2, "mean": 0.3, "std": 0.0},
               "Loss/scores/fake": {"num": 2, "mean": -0.3, "std": 0.0}}
        if tick == 0:
            row["Loss/r1_penalty"] = {"num": 1, "mean": 0.02, "std": 0.0}
        rows.append(row)
    with open(log / "stats.jsonl", "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    yy, xx = np.mgrid[:1100, :2200]
    for i, tag in enumerate(("000000", "000064")):
        for name in (f"fakes{tag}.png", f"fakes{tag}_combined.png"):
            sheet = np.stack([(xx + yy * (i + 1)) % 256, xx % 251,
                              yy % 241], axis=-1).astype(np.uint8)
            Image.fromarray(sheet).save(log / name)
    out = tmp_path / "report"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, os.path.join(root, "scripts",
                                      "training_demo_report.py"),
         "--log-dir", str(log), "--out", str(out)],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert sorted(os.listdir(out)) == [
        "curves.png", "sheet_first.png", "sheet_last.png"]
    assert Image.open(out / "curves.png").size[0] > 0
    for name, tag in (("sheet_first.png", "000000"),
                      ("sheet_last.png", "000064")):
        got = Image.open(out / name)
        assert got.size == (1024, 512)
        want = Image.open(log / f"fakes{tag}_combined.png")
        want.thumbnail((1024, 1024), Image.LANCZOS)
        assert np.array_equal(np.asarray(got), np.asarray(want))
