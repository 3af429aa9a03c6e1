"""The port's mask CLI (`migan_tpu_torch/cli/generate_masks.py`) against
`migan_tpu.cli.generate_masks` on the CPU: with the same arguments, by
--count and by --img-dir (stems of a nested tree of .png and .jpg files),
the same file names and the same PNG pixels, compared exactly."""

import numpy as np
import pytest
from PIL import Image

from migan_tpu.cli import generate_masks as jcli
from migan_tpu_torch.cli import generate_masks as tcli


def _pngs(d):
    return {p.name: np.asarray(Image.open(p)) for p in sorted(d.iterdir())}


def _run_both(tmp_path, args):
    tcli.main(["--out-dir", str(tmp_path / "port"), *args])
    jcli.main(["--out-dir", str(tmp_path / "jax"), *args])
    got, want = _pngs(tmp_path / "port"), _pngs(tmp_path / "jax")
    assert list(got) == list(want)
    for name in got:
        assert got[name].dtype == np.uint8
        np.testing.assert_array_equal(got[name], want[name])
    return got


@pytest.mark.parametrize("args", [
    ["--count", "6", "--resolution", "64"],
    ["--count", "4", "--resolution", "96", "--seed", "3",
     "--hole-range", "0.2", "0.5"],
])
def test_count_masks_equal_to_jax(tmp_path, args):
    got = _run_both(tmp_path, args)
    n, res = int(args[1]), int(args[3])
    assert list(got) == [f"{i:06d}.png" for i in range(n)]
    for m in got.values():
        assert m.shape == (res, res) and set(np.unique(m)) <= {0, 255}


def test_img_dir_masks_equal_to_jax(tmp_path):
    imgs = tmp_path / "imgs"
    (imgs / "sub").mkdir(parents=True)
    rng = np.random.RandomState(0)
    for name in ("b.png", "sub/a.jpg", "sub/c.png", "notes.txt"):
        Image.fromarray(rng.randint(0, 256, (8, 8, 3), np.uint8)).save(
            imgs / name, format="PNG")
    got = _run_both(tmp_path, ["--img-dir", str(imgs), "--resolution", "64",
                               "--seed", "1"])
    assert list(got) == ["a.png", "b.png", "c.png"]
