"""The port's evaluation CLI (`migan_tpu_torch/cli/evaluate.py`) against
`migan_tpu/cli/evaluate.py` on the CPU: one seeded directory of 6 images
at res 64, on-the-fly masks (seed 0), the same generator `.npz` and the
same detector `.pth` files. Mean LPIPS within 1e-4 (the generators agree
to ~1e-5, the detectors to ~1e-7), FID within 1% (6 images give a
rank-5 covariance, whose matrix square root amplifies small differences).
Also: the --real-acts-cache round trip, --data-parallel refused, and the
card as the default device.
"""

import numpy as np
import pytest
import jax
import torch
from PIL import Image

from migan_tpu.cli import evaluate as j_evaluate
from migan_tpu.io.checkpoint import save_npz as j_save_npz
from migan_tpu.models.migan_inference import (
    GeneratorConfig as JConfig, generator_init as j_init,
)
from migan_tpu_torch.cli import evaluate
from migan_tpu_torch.evalx import inception, lpips

RES = 64
N_IMAGES = 6


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """images/, the generator .npz, and the two detector .pth files."""
    root = tmp_path_factory.mktemp("eval")
    images = root / "images"
    images.mkdir()
    rng = np.random.RandomState(0)
    for i in range(N_IMAGES):
        size = (RES, RES) if i % 2 else (80, 72)   # some need the resize
        Image.fromarray(rng.randint(0, 256, (*size, 3), np.uint8)).save(
            images / f"{i}.png")
    npz = str(root / "migan64.npz")
    j_save_npz(npz, j_init(jax.random.PRNGKey(2), JConfig(resolution=RES)))
    inc, lp = str(root / "inception.pth"), str(root / "lpips.pth")
    torch.save(inception.seeded_state_dict(0), inc)
    torch.save(lpips.seeded_state_dict(1), lp)
    return root, ["--model-name", "migan-64", "--model-path", npz,
                  "--real-dir", str(images), "--inception-weights", inc,
                  "--lpips-weights", lp, "--batch-size", "4"]


@pytest.fixture(scope="module")
def port_run(bundle):
    """The port's evaluation on the CPU, writing the real-acts cache."""
    root, argv = bundle
    argv = argv + ["--device", "cpu", "--real-acts-cache",
                   str(root / "real_acts.npz")]
    details = {}
    result = evaluate.main(argv, details=details)
    return argv, result, details


def test_evaluate_matches_jax_package(bundle, port_run):
    _, argv = bundle
    want_fid, want_lpips = j_evaluate.main(argv)
    _, (fid, lp), details = port_run
    assert details["n"] == N_IMAGES
    assert details["lpips"].shape == (N_IMAGES,)
    assert details["real_acts"].shape == details["fake_acts"].shape == (
        N_IMAGES, 2048)
    assert np.isfinite(fid) and fid > 0
    # the loop's log: per batch its end, its items and its wait
    ends, items, waits = zip(*details["batches"])
    assert sum(items) == N_IMAGES and list(ends) == sorted(ends)
    assert 0 <= details["waited"] == pytest.approx(sum(waits))
    assert details["waited"] <= ends[-1] <= details["seconds"]
    assert abs(lp - want_lpips) <= 1e-4, (lp, want_lpips)
    assert abs(fid - want_fid) <= 0.01 * abs(want_fid), (fid, want_fid)


def test_real_acts_cache_round_trip(port_run):
    """The first run wrote the real activations; a second run reads them
    back instead of running the detector on the real images, and gives
    the same numbers."""
    argv, result, first = port_run
    cache = argv[argv.index("--real-acts-cache") + 1]
    np.testing.assert_array_equal(np.load(cache)["acts"],
                                  first["real_acts"])
    second = {}
    assert evaluate.main(argv, details=second) == result
    np.testing.assert_array_equal(second["real_acts"], first["real_acts"])
    np.testing.assert_array_equal(second["fake_acts"], first["fake_acts"])


def test_data_parallel_refused(bundle):
    _, argv = bundle
    with pytest.raises(SystemExit, match="data-parallel"):
        evaluate.main(argv + ["--device", "cpu", "--data-parallel"])


def test_entry_points_default_to_the_card(bundle, monkeypatch):
    """--device defaults to cuda, and without a card the CLIs raise
    instead of falling back to the CPU."""
    from migan_tpu_torch.cli import serve

    _, argv = bundle
    assert evaluate.get_args(argv).device == "cuda"
    assert serve.get_args(["--model-name", "m", "--model-path", "p"]
                          ).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate.main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(argv[:4] + ["--port", "0"])
