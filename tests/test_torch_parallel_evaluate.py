"""The port's evaluation CLI (`cli/evaluate.py`) sharded over 2 gloo ranks
(`tests/test_torch_parallel_worker.py`, `--data-parallel`) against the
same CLI in one process with `--num-workers 2` (the per-item mask stream
that a sharded run draws), on 5 seeded images at res 64 (rank 1's last
item is the extend padding): per-item LPIPS within 1e-5 and each item's Inception
activations within 1e-5 relative L2 (the same items through the same
nets, in batches of other rows), FID within 1e-4 relative, rank 0 alone
writing the real-activations cache. The two runs go at once, so that
their 2048-dim matrix square roots overlap."""

import json
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from migan_tpu_torch.cli import evaluate
from migan_tpu_torch.evalx import inception, lpips
from migan_tpu_torch.io import save_npz
from migan_tpu_torch.models.migan_inference import (GeneratorConfig,
                                                    generator_init)
from test_torch_parallel_worker import launch

RES, N_ITEMS = 64, 5


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel_l2(a, b):
    return np.linalg.norm(a - b, axis=1) / np.linalg.norm(b, axis=1)


def test_two_rank_evaluation_matches_one_process(tmp_path):
    images = tmp_path / "images"
    images.mkdir()
    rng = np.random.RandomState(0)
    for i in range(N_ITEMS):
        Image.fromarray(rng.randint(0, 256, (RES, RES, 3), np.uint8)).save(
            images / f"{i}.png")
    npz, inc, lp = (str(tmp_path / f) for f in
                    ("g.npz", "inception.pth", "lpips.pth"))
    g = generator_init(GeneratorConfig(resolution=RES),
                       torch.Generator().manual_seed(2))
    with torch.no_grad():
        for name, p in g.named_parameters():
            if name.endswith("noise_strength"):
                p.fill_(0.1)
    save_npz(npz, g)
    torch.save(inception.seeded_state_dict(0), inc)
    torch.save(lpips.seeded_state_dict(1), lp)
    argv = ["--model-name", f"migan-{RES}", "--model-path", npz,
            "--real-dir", str(images), "--inception-weights", inc,
            "--lpips-weights", lp, "--batch-size", "2", "--device", "cpu"]
    cache = tmp_path / "real_acts.npz"
    (tmp_path / "argv.json").write_text(json.dumps(
        argv + ["--data-parallel", "--real-acts-cache", str(cache)]))
    out = tmp_path / "two.npz"
    logs = []
    ranks = threading.Thread(target=lambda: logs.extend(launch(
        "evaluate", str(tmp_path / "argv.json"), str(out))))
    ranks.start()
    try:
        details = {}
        fid, lp_mean = evaluate.main(argv + ["--num-workers", "2"],
                                     details=details)
    finally:
        ranks.join()
    assert len(logs) == 2, "the ranks failed"

    two = np.load(out)
    assert two["lpips"].shape == (N_ITEMS,)
    np.testing.assert_allclose(two["lpips"], details["lpips"], rtol=0,
                               atol=1e-5)
    for k in ("real_acts", "fake_acts"):
        assert two[k].shape == (N_ITEMS, 2048)
        assert _rel_l2(two[k], details[k]).max() <= 1e-5, k
    # the items are told apart: each composite moves its activations
    assert _rel_l2(details["fake_acts"], details["real_acts"]).min() > 1e-3
    np.testing.assert_allclose(float(two["fid"]), fid, rtol=1e-4)
    for r, log in enumerate(logs):
        assert f"distributed: backend gloo, world 2, rank {r}" in log
        assert ("cached real activations" in log) == (r == 0)
    np.testing.assert_array_equal(np.load(cache)["acts"], two["real_acts"])
