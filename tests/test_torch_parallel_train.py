"""The port's training loop (`train/loop.py::train_stage`) on 2 gloo ranks
(`tests/test_torch_parallel_worker.py`), 3 steps of
`test_torch_train_loop.py`'s smoke config (the JAX package's loop-test config: 16 px, batch 8, R1
every 2 steps, a tick every step), as `tests/test_multihost.py` holds the
JAX package's 2-process run:

  - both ranks hold the same state, and two launches agree bit for bit;
  - the state is within the JAX test's bounds (rtol 0.05, atol 1.5e-3) of
    the one-process run: the gradient's all-reduce sums in another order,
    and Adam's first steps (~lr sign(g)) amplify that where g is near 0;
  - the first tick's losses (one step from the same state, data and
    noise) within rtol 1e-5 of the one-process run's;
  - rank 0 alone writes: one TensorBoard event file, no tick twice in
    stats.jsonl, one start line naming the backend, world and rank;
  - the checkpoint resumes in one process.
"""

import glob
import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from migan_tpu_torch.train import checkpoint as ckpt
from migan_tpu_torch.train import loop
from test_torch_train_loop import smoke_cfg  # noqa: F401 (a fixture)
from test_torch_parallel_worker import launch


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _flat(sd, prefix=""):
    """{path: tensor} of a checkpoint state dict's tensors and numbers."""
    out = {}
    if isinstance(sd, dict):
        for k, v in sd.items():
            out.update(_flat(v, f"{prefix}.{k}"))
    elif isinstance(sd, (list, tuple)):
        for i, v in enumerate(sd):
            out.update(_flat(v, f"{prefix}[{i}]"))
    elif isinstance(sd, torch.Tensor):
        out[prefix] = sd
    elif isinstance(sd, (int, float)):
        out[prefix] = torch.as_tensor(sd)
    return out


def _launch(tmp_path, cfg, tag):
    cfg = json.loads(json.dumps(cfg))
    cfg["train"]["log_dir"] = str(tmp_path / f"log_{tag}")
    path = tmp_path / f"cfg_{tag}.json"
    path.write_text(json.dumps(cfg))
    out = str(tmp_path / f"state_{tag}")
    logs = launch("train", str(path), out)
    return ([_flat(torch.load(f"{out}.{r}", weights_only=False))
             for r in range(2)], logs, cfg["train"]["log_dir"])


def _first_tick_losses(log_dir):
    with open(os.path.join(log_dir, "stats.jsonl")) as f:
        rows = [json.loads(l) for l in f]
    return {k: v["mean"] for k, v in rows[0].items() if k.startswith("Loss/")}


def test_two_rank_train_stage(tmp_path, smoke_cfg):  # noqa: F811
    cfg = smoke_cfg
    with ThreadPoolExecutor(2) as pool:     # the two launches at once
        runs = [pool.submit(_launch, tmp_path, cfg, tag) for tag in "ab"]
        ((a0, a1), logs, log_a), ((b0, _), _, _) = [r.result() for r in runs]
    assert a0.keys() == a1.keys() == b0.keys()
    for k in a0:
        assert torch.equal(a0[k], a1[k]), f"ranks disagree at {k}"
        assert torch.equal(a0[k], b0[k]), f"launches disagree at {k}"
    for r, log in enumerate(logs):
        assert f"distributed: backend gloo, world 2, rank {r}, device " \
            "cpu" in log
        assert ("tick 0" in log) == (r == 0)

    cfg_sp = json.loads(json.dumps(cfg))
    cfg_sp["train"]["log_dir"] = str(tmp_path / "log_sp")
    one = _flat(loop.train_stage(cfg_sp, max_steps=3,
                                 device="cpu").state_dict())
    assert one.keys() == a0.keys()
    assert one[".step"] == a0[".step"] == 3
    assert one[".nimg"] == a0[".nimg"] == 24
    for k in one:
        np.testing.assert_allclose(a0[k].double().numpy(),
                                   one[k].double().numpy(), rtol=0.05,
                                   atol=1.5e-3, err_msg=k)
    want = _first_tick_losses(cfg_sp["train"]["log_dir"])
    got = _first_tick_losses(log_a)
    assert got.keys() == want.keys() and "Loss/r1_penalty" in got
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)

    events = glob.glob(os.path.join(log_a, "events.out.tfevents.*"))
    assert len(events) == 1, events
    with open(os.path.join(log_a, "stats.jsonl")) as f:
        ticks = [json.loads(l)["tick"] for l in f]
    assert ticks == sorted(set(ticks)) and len(ticks) == 3
    assert os.path.isfile(os.path.join(log_a, "reals.png"))

    # the 2-rank checkpoint resumes in one process
    cfg_r = json.loads(json.dumps(cfg_sp))
    cfg_r["train"]["log_dir"] = str(tmp_path / "log_resumed")
    cfg_r["train"]["resume_path"] = os.path.join(log_a, "weight")
    state = loop.train_stage(cfg_r, max_steps=4, device="cpu")
    assert state.step == 4 and state.nimg == 32
    assert ckpt.latest(os.path.join(log_a, "weight")).endswith("step_00000003")
