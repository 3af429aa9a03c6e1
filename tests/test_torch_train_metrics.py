"""The port's in-loop metric branch (`migan_tpu_torch/train/loop.py`:
`_build_metric_ctx`, `_run_metrics`, the `snapshot.evaluate` gating and
the best checkpoint) on the CPU, as `tests/test_train_metrics.py` drives
the JAX package's: `train_stage` at 16 px with a random detector
(`eval.allow_random_detector`), an evaluation every tick, writing
`metric-*.jsonl`, `Metrics/fid` lines in stats.jsonl and the run log, one
best checkpoint at the lowest FID, the dataset statistics computed once
and read back from `fid-cache/`; the best checkpoint replaced by a lower
FID only; the skip message without detector weights or the opt-in; and
`_run_metrics` against the JAX package's on the same EMA weights, the
same detector and the same global np.random seed: FID within 1e-3
relative (float32 features in another summation order, one 2048-dim
`sqrtm` on each side).
"""

import glob
import json
import os
import types

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from migan_tpu.evalx import inception as jinc
from migan_tpu.io import checkpoint as jckpt
from migan_tpu.models import migan as jm
from migan_tpu.train import loop as jloop
from migan_tpu_torch.evalx import inception as tinc
from migan_tpu_torch.io.train_weights import params_to_state
from migan_tpu_torch.models import migan as tm
from migan_tpu_torch.train import checkpoint as ckpt
from migan_tpu_torch.train import loop


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The gate runs 6 test workers on one host: torch's default of one
    thread per core in each of them oversubscribes it several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


FID_RTOL = 1e-3
NARROW = dict(resolution=16, ch_base=512, depthwise=True,
              reparametrize=True, num_reparam_tensors=2)


@pytest.fixture()
def metric_cfg(tmp_path):
    """The JAX package's metric-loop config (tests/test_train_metrics.py)
    with the port's narrow nets: 16 px, batch 8, a tick and an evaluation
    every step, 4 evaluation items."""
    droot = tmp_path / "data" / "train_256" / "a"
    droot.mkdir(parents=True)
    rng = np.random.RandomState(0)
    for i in range(8):
        Image.fromarray(rng.randint(0, 255, (32, 32, 3), np.uint8)).save(
            droot / f"{i}.jpg")
    ds_cfg = {
        "name": "smoke_ds", "type": "places2",
        "root_dir": str(tmp_path / "data"), "mode": "train256",
        "loader": [{"type": "DefaultLoader", "args": {}}],
        "formatter": {"type": "FreeFormMaskFormatter",
                      "args": {"resolution": 16, "random_flip": True,
                               "hole_range": [0.0, 1.0]}},
    }
    return {
        "env": {"rnd_seed": 0},
        "model_g": {"name": "smoke_g", "type": "migan_generator", "args": {
            "encoder": {"args": {**NARROW, "ic_n": 4}},
            "synthesis": {"args": {**NARROW, "rgb_n": 3}}}},
        "model_d": {"name": "smoke_d", "type": "migan_discriminator",
                    "args": {**NARROW, "ic_n": 4}},
        "eval": {"dataset": ds_cfg, "batch_size": 4, "max_items": 4,
                 "allow_random_detector": True},
        "train": {
            "log_dir": str(tmp_path / "log"),
            "dataset": dict(ds_cfg),
            "batch_size": 8, "dataset_num_workers": 2,
            "loss_kwargs": {"r1_gamma": 10},
            "g_opt_kwargs": {"lr": 1e-3, "betas": [0, 0.99], "eps": 1e-8},
            "g_reg_interval": 4,
            "d_opt_kwargs": {"lr": 1e-3, "betas": [0, 0.99], "eps": 1e-8},
            "d_reg_interval": 2,
            "total_kimg": 1, "ema_kimg": 20,
            "kimg_per_tick": 0.008,   # a tick every step
            "snapshot": {"image": 1000, "checkpoint": 1000, "evaluate": 1},
            "metrics": ["fid5k_full_inpainting"],
        },
    }


def _best_steps(log_dir):
    best = os.path.join(log_dir, "weight", "best")
    if not os.path.isdir(best):
        return []
    return sorted(d for d in os.listdir(best) if d.startswith("step_"))


def test_metric_branch_and_best_checkpoint(metric_cfg, capsys):
    state = loop.train_stage(metric_cfg, max_steps=3, device="cpu")
    assert state.step == 3
    log_dir = metric_cfg["train"]["log_dir"]
    out = capsys.readouterr().out

    # one record per evaluation (ticks 1 and 2)
    with open(os.path.join(log_dir,
                           "metric-fid5k_full_inpainting.jsonl")) as f:
        mrecs = [json.loads(line) for line in f]
    assert len(mrecs) == 2
    fids = [r["results"]["fid"] for r in mrecs]
    assert all(np.isfinite(v) and v >= 0 for v in fids)
    assert all(r["metric"] == "fid5k_full_inpainting"
               and r["total_time"] > 0 for r in mrecs)

    with open(os.path.join(log_dir, "stats.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["Metrics/fid"] for r in recs if "Metrics/fid" in r] == fids
    assert [line for line in out.splitlines()
            if "Metrics/fid" in line][0].startswith("tick 1  Metrics/fid")

    # one best checkpoint, at the lower FID's step (evaluations after
    # steps 2 and 3)
    want = 2 if fids[0] <= fids[1] else 3
    assert _best_steps(log_dir) == [f"step_{want:08d}"]
    ema = ckpt.extract_field(os.path.join(log_dir, "weight", "best",
                                          f"step_{want:08d}"))
    assert set(ema) == set(state.G_ema.state_dict())

    # the real features computed at the first evaluation, read back at
    # the second
    (cache,) = glob.glob(os.path.join(log_dir, "fid-cache",
                                      "fid-stats-*.pkl"))
    assert out.count(f"dataset feature stats computed, saved to {cache}") \
        == 1
    assert out.count(f"dataset feature stats read from {cache}") == 1
    assert "training-time FID detector flavor: pytorch_fid" in out


def test_best_checkpoint_replaced_only_by_a_lower_fid(metric_cfg,
                                                      monkeypatch):
    """Evaluations after steps 2-5 report FIDs 5, 3, 4, 2: the best
    checkpoint moves to step 3, stays there at 4, moves to step 5, and
    every superseded one is deleted."""
    log_dir = metric_cfg["train"]["log_dir"]
    fids = iter([5.0, 3.0, 4.0, 2.0])
    seen = []

    def fake_run(state, ctx, log_dir_):
        seen.append(_best_steps(log_dir))
        return next(fids)

    monkeypatch.setattr(loop, "_run_metrics", fake_run)
    loop.train_stage(metric_cfg, max_steps=5, device="cpu")
    assert seen == [[], ["step_00000002"], ["step_00000003"],
                    ["step_00000003"]]
    assert _best_steps(log_dir) == ["step_00000005"]


def test_metric_ctx_requires_weights_or_optin(metric_cfg, tmp_path, capsys):
    """Without weights or the random-detector opt-in the metrics are
    skipped with a log line; with the opt-in the ctx holds a random
    pytorch_fid detector; with a weight file its flavor is detected."""
    metric_cfg["eval"].pop("allow_random_detector")
    assert loop._build_metric_ctx(metric_cfg, "cpu") is None
    assert "skipping metric evaluation" in capsys.readouterr().out

    metric_cfg["eval"]["allow_random_detector"] = True
    ctx = loop._build_metric_ctx(metric_cfg, "cpu")
    assert ctx is not None and ctx["max_items"] == 4
    assert ctx["detector_tag"] == "inception-pytorch_fid"
    assert ctx["dataset_tag"] == "smoke_ds"

    path = tmp_path / "inception-2015-12-05.pt"
    torch.save(tinc.seeded_state_dict(0, n_images=1, flavor="nvidia_tf"),
               path)
    metric_cfg["eval"]["inception_weights"] = str(path)
    ctx = loop._build_metric_ctx(metric_cfg, "cpu")
    assert ctx["detector_tag"] == "inception-nvidia_tf"
    assert ctx["detector"](torch.rand(1, 16, 16, 3)).shape == (1, 2048)


def test_run_metrics_equal_to_jax(metric_cfg):
    """Both packages' `_run_metrics` on the same EMA weights (the JAX
    initialization carried across), the same random detector and the
    same global np.random seed; the port's evaluation generator is its
    own copy of the EMA, refreshed at each evaluation."""
    jcfg = jm.MiganConfig(**NARROW)
    params = jax.jit(jm.generator_init, static_argnums=1)(
        jax.random.PRNGKey(4), jcfg)
    G = tm.Generator(tm.MiganConfig(**NARROW))
    G.load_state_dict(params_to_state(jckpt._flatten(params)), strict=True)
    G.eval().requires_grad_(False)
    metric_cfg["eval"]["max_items"] = 8

    jctx = jloop._build_metric_ctx(metric_cfg)
    tctx = loop._build_metric_ctx(metric_cfg, "cpu")
    tctx["detector"] = tinc.make_detector(
        tinc.from_jax_params(jinc.inception_init(jax.random.PRNGKey(0))),
        "pytorch_fid")
    log_dir = metric_cfg["train"]["log_dir"]
    os.makedirs(log_dir)
    np.random.seed(11)
    want = jloop._run_metrics(metric_cfg,
                              types.SimpleNamespace(params_G_ema=params),
                              jcfg, jctx, os.path.join(log_dir, "j"))
    np.random.seed(11)
    state = types.SimpleNamespace(G_ema=G)
    got = loop._run_metrics(state, tctx, log_dir)
    assert np.isfinite(got) and got > 0
    assert abs(got - want) <= FID_RTOL * abs(want), (got, want)

    gen = tctx["G"]
    assert gen is not G
    live = {p.data_ptr() for p in G.parameters()}
    assert not live & {p.data_ptr() for p in gen.parameters()}
    with torch.no_grad():
        for p in G.parameters():
            p.add_(0.5)
    tctx["metrics"] = []           # refresh the copy, compute nothing
    loop._run_metrics(state, tctx, log_dir)
    assert tctx["G"] is gen
    for a, b in zip(gen.parameters(), G.parameters()):
        assert torch.equal(a, b)
