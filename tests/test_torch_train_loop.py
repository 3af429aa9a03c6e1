"""The port's training checkpoint, tick loop and CLI (`train/checkpoint.py`,
`train/loop.py`, `cli/train.py`) on the CPU, and the export CLI reading
the port's checkpoint: a save/restore round trip with the Adam moments,
`latest` skipping a torn temporary directory, `extract_field`, the JAX
package's (orbax) checkpoint refused; `train_stage` at 16 px writing
stats.jsonl, grids and checkpoints; a run stopped and resumed equal to
the uninterrupted run bit for bit; the metric branch's skip and refusal;
the CLI on a config root of its own, on the CPU by `--device cpu` only.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from migan_tpu_torch.cli import export as export_cli
from migan_tpu_torch.cli import train as train_cli
from migan_tpu_torch.models import migan as tm
from migan_tpu_torch.train import checkpoint as ckpt
from migan_tpu_torch.train import loop
from migan_tpu_torch.train import train_step as tts


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The gate runs 6 test workers on one host: torch's default of one
    thread per core in each of them oversubscribes it several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


NARROW = dict(resolution=16, ch_base=512, depthwise=True,
              reparametrize=True, num_reparam_tensors=2)


def _net_args(**kw):
    return {**NARROW, **kw}


@pytest.fixture()
def smoke_cfg(tmp_path):
    """The JAX package's loop-test config (tests/test_train_loop.py) with
    narrower nets: 16 px, batch 8, a tick every step, R1 every 2 steps."""
    droot = tmp_path / "data" / "train_256" / "a"
    droot.mkdir(parents=True)
    rng = np.random.RandomState(0)
    for i in range(8):
        Image.fromarray(rng.randint(0, 255, (32, 32, 3), np.uint8)).save(
            droot / f"{i}.jpg")
    return {
        "env": {"rnd_seed": 0},
        "model_g": {"name": "smoke_g", "type": "migan_generator", "args": {
            "encoder": {"args": _net_args(ic_n=4)},
            "synthesis": {"args": _net_args(rgb_n=3)}}},
        "model_d": {"name": "smoke_d", "type": "migan_discriminator",
                    "args": _net_args(ic_n=4)},
        "train": {
            "log_dir": str(tmp_path / "log"),
            "dataset": {
                "name": "smoke_ds", "type": "places2",
                "root_dir": str(tmp_path / "data"), "mode": "train256",
                "loader": [{"type": "DefaultLoader", "args": {}}],
                "formatter": {"type": "FreeFormMaskFormatter",
                              "args": {"resolution": 16, "random_flip": True,
                                       "hole_range": [0.0, 1.0]}}},
            "batch_size": 8, "dataset_num_workers": 2,
            "loss_kwargs": {"r1_gamma": 10},
            "g_opt_kwargs": {"lr": 1e-3, "betas": [0, 0.99], "eps": 1e-8},
            "g_reg_interval": 4,
            "d_opt_kwargs": {"lr": 1e-3, "betas": [0, 0.99], "eps": 1e-8},
            "d_reg_interval": 2,
            "total_kimg": 1, "ema_kimg": 20,
            "kimg_per_tick": 0.008,   # a tick every step
            "snapshot": {"image": 2, "checkpoint": 2, "evaluate": 1000},
            "metrics": [],
        },
    }


def _state(seed=0, **kw):
    cfg = tm.MiganConfig(**{**NARROW, **kw})
    return tts.init_train_state(torch.Generator().manual_seed(seed), cfg,
                                cfg, tts.TrainConfig(batch_size=4))


def _equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    else:
        assert a == b


def test_checkpoint_round_trip_with_adam_moments(tmp_path):
    state = _state()
    step = tts.make_train_step(state.G.cfg, state.D.cfg,
                               tts.TrainConfig(batch_size=4))
    rng = np.random.RandomState(1)
    batch = {"real": torch.from_numpy(
        rng.rand(4, 16, 16, 3).astype(np.float32) * 2 - 1),
        "mask": torch.from_numpy(
            (rng.rand(4, 16, 16, 1) > 0.5).astype(np.float32))}
    step(state, batch, torch.Generator().manual_seed(2), do_dr1=True)
    assert state.opt_G.state_dict()["state"]      # moments exist
    path = ckpt.save(str(tmp_path / "weight"), state.step, state)
    assert os.path.basename(path) == "step_00000001"
    fresh = ckpt.restore(path, _state(seed=5))
    _equal(fresh.state_dict(), state.state_dict())
    _equal(ckpt.extract_field(path, "params_G_ema"),
           state.G_ema.state_dict())
    with pytest.raises(ValueError, match="unknown TrainState field"):
        ckpt.extract_field(path, "params_X")


def test_latest_skips_a_torn_temporary_dir(tmp_path):
    state = _state()
    d = str(tmp_path / "weight")
    assert ckpt.latest(d) is None
    ckpt.save(d, 2, state)
    os.makedirs(os.path.join(d, "step_00000004.tmp-torn"))
    assert ckpt.latest(d).endswith("step_00000002")
    ckpt.save(d, 4, state)
    assert ckpt.latest(d).endswith("step_00000004")
    assert sorted(os.listdir(d)) == ["step_00000002", "step_00000004",
                                     "step_00000004.tmp-torn"]


def test_jax_checkpoint_is_refused(tmp_path):
    """An orbax TrainState directory (files, no state.pt)."""
    d = tmp_path / "step_00000002"
    d.mkdir()
    (d / "_CHECKPOINT_METADATA").write_text("{}")
    for fn in (lambda: ckpt.extract_field(str(d)),
               lambda: ckpt.restore(str(d), _state())):
        with pytest.raises(ValueError, match="orbax"):
            fn()


def test_train_stage_smoke(smoke_cfg):
    state = loop.train_stage(smoke_cfg, max_steps=4, device="cpu")
    log = smoke_cfg["train"]["log_dir"]
    assert state.step == 4 and state.nimg == 32
    with open(os.path.join(log, "stats.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["tick"] for r in rows] == [0, 1, 2, 3]
    assert all(np.isfinite(r["Loss/G/loss"]["mean"]) for r in rows)
    assert "Loss/r1_penalty" in rows[0] and "Loss/r1_penalty" in rows[2]
    for name in ("reals.png", "masks.png", "erased.png", "fakes000000.png",
                 "fakes000000_combined.png"):
        assert os.path.isfile(os.path.join(log, name)), name
    # ticks 0 and 2, and the last step
    assert sorted(os.listdir(os.path.join(log, "weight"))) == [
        "step_00000001", "step_00000003", "step_00000004"]


def test_train_stage_resume_bit_equal(smoke_cfg, tmp_path):
    """2 steps, then a resume to 4 with another loader worker count, equal
    bit for bit to 4 uninterrupted steps: G, D, the EMA, both Adam states,
    step and nimg."""
    cfg_a = copy.deepcopy(smoke_cfg)
    cfg_a["train"]["log_dir"] = str(tmp_path / "straight")
    state_a = loop.train_stage(cfg_a, max_steps=4, device="cpu")
    cfg_b = copy.deepcopy(smoke_cfg)
    cfg_b["train"]["log_dir"] = str(tmp_path / "first")
    loop.train_stage(cfg_b, max_steps=2, device="cpu")
    cfg_c = copy.deepcopy(smoke_cfg)
    cfg_c["train"]["log_dir"] = str(tmp_path / "resumed")
    cfg_c["train"]["resume_path"] = str(tmp_path / "first" / "weight")
    cfg_c["train"]["dataset_num_workers"] = 3
    state_c = loop.train_stage(cfg_c, max_steps=4, device="cpu")
    _equal(state_c.state_dict(), state_a.state_dict())


def test_metric_branch_skips_or_refuses(capsys):
    cfg = {"train": {"metrics": ["fid10k_full_inpainting"]},
           "eval": {"dataset": {"type": "places2"}}}
    assert loop._build_metric_ctx(cfg) is None
    assert "skipping metric evaluation" in capsys.readouterr().out
    cfg["eval"]["allow_random_detector"] = True
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        loop._build_metric_ctx(cfg)
    assert loop._build_metric_ctx({"train": {"metrics": []}}) is None


def test_export_cli_reads_the_port_checkpoint(tmp_path):
    """The export CLI folds a checkpoint's params_G_ema (default widths at
    16 px, 2 re-param tensors), from the `weight/` directory (its newest
    step) and from a step directory."""
    cfg = tm.MiganConfig(resolution=16, num_reparam_tensors=2)
    state = tts.init_train_state(torch.Generator().manual_seed(3), cfg,
                                 tm.MiganConfig(**NARROW),
                                 tts.TrainConfig(batch_size=4))
    with torch.no_grad():
        for p in state.G_ema.parameters():
            p.add_(0.01)
    weight = str(tmp_path / "weight")
    ckpt.save(weight, 1, _state())
    path = ckpt.save(weight, 3, state)
    imgs, masks = tmp_path / "imgs", tmp_path / "masks"
    imgs.mkdir()
    masks.mkdir()
    rng = np.random.RandomState(0)
    Image.fromarray(rng.randint(0, 256, (16, 16, 3), np.uint8)).save(
        imgs / "0.png")
    Image.fromarray(np.where(rng.rand(16, 16) > .5, 255, 0).astype(
        np.uint8)).save(masks / "0.png")
    for src in (weight, path):
        out = tmp_path / f"out_{os.path.basename(src)}"
        stats = export_cli.main([
            "--model-path", src, "--resolution", "16",
            "--num-reparam-tensors", "2", "--origs-dir", str(imgs),
            "--masks-dir", str(masks), "--output-dir", str(out),
            "--num-samples", "1", "--device", "cpu"])
        assert stats["diff_pct"] < 0.5
        assert (out / "models" / "migan.pt2").is_file()
    from migan_tpu_torch.export.fold import fold_generator
    from migan_tpu_torch.io import load_npz

    want = fold_generator(state.G_ema).state_dict()
    got = load_npz(str(tmp_path / "out_weight" / "models" / "migan.npz"))
    for k, v in got.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0)


def test_train_cli_on_a_config_root(smoke_cfg, tmp_path):
    """`python -m migan_tpu_torch.cli.train --experiment <name>
    --config-root <root> --device cpu`: the run directory under
    env.log_root_dir with the resolved config, the run log, the code
    snapshot and a checkpoint; --set overrides applied."""
    root = tmp_path / "configs"
    (root / "experiment").mkdir(parents=True)
    exp = copy.deepcopy(smoke_cfg)
    del exp["train"]["log_dir"]
    exp["env"]["log_root_dir"] = str(tmp_path / "runs")
    exp["train"]["save_code"] = True
    with open(root / "experiment" / "tiny.yaml", "w") as f:
        yaml.safe_dump(exp, f)
    state = train_cli.main([
        "--experiment", "tiny", "--config-root", str(root), "--device",
        "cpu", "--max-steps", "2", "--signature", "s",
        "--set", "train.batch_size=4"])
    assert state.step == 2 and state.nimg == 8
    (run,) = os.listdir(tmp_path / "runs")
    assert run.endswith("-smoke_g-s")
    run = tmp_path / "runs" / run
    with open(run / "config.yaml") as f:
        resolved = yaml.safe_load(f)
    assert resolved["train"]["batch_size"] == 4
    assert resolved["train"]["log_dir"] == str(run)
    assert (run / "train.log").is_file()
    assert (run / "code" / "migan_tpu_torch" / "cli" / "train.py").is_file()
    assert ckpt.latest(str(run / "weight")).endswith("step_00000002")


def test_train_cli_cuda_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--experiment", "migan_places256"])
