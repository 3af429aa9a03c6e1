"""The port's demo CLI reproduces all four golden suites of
tests/test_golden_regression.py within 1 uint8, on the CPU, from the same
generator_init(PRNGKey(0)) weights through the .npz bridge (the goldens
were written by the JAX demo)."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from test_golden_regression import GOLDENS, SUITES


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The gate runs 6 test workers on one host: torch's default of one
    thread per core in each of them oversubscribes it several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights_npz(tmp_path_factory):
    from migan_tpu.io.checkpoint import save_npz
    from migan_tpu.models.migan_inference import (
        GeneratorConfig, generator_init,
    )

    d = tmp_path_factory.mktemp("golden_w_torch")
    out = {}
    for res in (256, 512):
        out[res] = str(d / f"w{res}.npz")
        save_npz(out[res], generator_init(jax.random.PRNGKey(0),
                                          GeneratorConfig(resolution=res)))
    return out


@pytest.mark.parametrize("suite", sorted(SUITES))
def test_port_demo_golden_suite(suite, weights_npz, tmp_path):
    from migan_tpu_torch.cli import demo

    model, res, ids, flags = SUITES[suite]
    sdir = os.path.join(GOLDENS, suite)
    out = tmp_path / "out"
    demo.main([
        "--model-name", model, "--model-path", weights_npz[res],
        "--images-dir", os.path.join(sdir, "inputs", "images"),
        "--masks-dir", os.path.join(sdir, "inputs", "masks"),
        "--output-dir", str(out), "--device", "cpu", *flags,
    ])
    for stem, _ in ids:
        want = np.asarray(Image.open(os.path.join(sdir, f"{stem}.png")),
                          np.int32)
        got = np.asarray(Image.open(out / f"{stem}.png"), np.int32)
        assert want.shape == got.shape, f"{suite}/{stem}: shape mismatch"
        d = np.abs(want - got)
        assert d.max() <= 1, f"{suite}/{stem}: max |diff| {d.max()}"


def test_port_demo_batched_matches_per_image(weights_npz, tmp_path):
    """--batch-size > 1 (zero-padded tail batch) writes the same images."""
    from migan_tpu_torch.cli import demo

    sdir = os.path.join(GOLDENS, "demo_ffhq256", "inputs")
    outs = []
    for bs in ("1", "3"):
        out = tmp_path / f"bs{bs}"
        demo.main(["--model-name", "migan-256", "--model-path",
                   weights_npz[256],
                   "--images-dir", os.path.join(sdir, "images"),
                   "--masks-dir", os.path.join(sdir, "masks"),
                   "--output-dir", str(out), "--device", "cpu",
                   "--batch-size", bs, "--io-workers", "2"])
        outs.append(out)
    names = sorted(os.listdir(outs[0]))
    assert names == sorted(os.listdir(outs[1])) and len(names) == 4
    for name in names:
        a = np.asarray(Image.open(outs[0] / name), np.int32)
        b = np.asarray(Image.open(outs[1] / name), np.int32)
        assert np.abs(a - b).max() <= 1, name


def test_load_model_cuda_without_card_raises(weights_npz):
    """--device cuda never falls back to the CPU."""
    from migan_tpu_torch.cli.demo import load_model

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model("migan-256", weights_npz[256], device="cuda")
