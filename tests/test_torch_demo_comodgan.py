"""The port's demo CLI on the Co-Mod-GAN model names (`cli/demo.py`
through `models/comodgan.py::load_comodgan_forward`) against the JAX
package's `load_comodgan_forward` on the CPU: comodgan-32 at narrow
widths (`--ch-base`, `--ch-max`), one fixed z (`--z-npy`) and
`--noise-mode const`, the same JAX-initialized weights (`.npz`), the JAX
demo's pre- and post-processing on the JAX side. Composites within 1
uint8 (float32 sums in another order, then rounding to uint8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from migan_tpu.data import preprocess as jpre
from migan_tpu.io import checkpoint as jckpt
from migan_tpu.models import comodgan as jc
from migan_tpu_torch.cli import demo


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The gate runs 6 test workers on one host: torch's default of one
    thread per core in each of them oversubscribes it several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


RES, CH_BASE, CH_MAX = 32, 512, 64


@pytest.fixture(scope="module")
def comodgan_npz(tmp_path_factory):
    cfg = jc.CoModGANConfig(resolution=RES, ch_base=CH_BASE, ch_max=CH_MAX)
    flat = jckpt._flatten(jax.jit(jc.generator_init, static_argnums=1)(
        jax.random.PRNGKey(3), cfg))
    for k in flat:                 # so that 'const' noise shows
        if k.endswith("noise_strength"):
            flat[k] = np.float32(0.2)
    path = str(tmp_path_factory.mktemp("cmg") / "cmg.npz")
    np.savez(path, **flat)
    return path


def test_demo_comodgan_matches_jax(comodgan_npz, tmp_path):
    npz = comodgan_npz
    rng = np.random.RandomState(5)
    z = rng.randn(512).astype(np.float32)
    z_npy = str(tmp_path / "z.npy")
    np.save(z_npy, z)
    (tmp_path / "images").mkdir()
    (tmp_path / "masks").mkdir()
    for name, (w, h) in (("a", (32, 32)), ("b", (48, 40))):
        Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8)).save(
            tmp_path / "images" / f"{name}.png")
        mask = np.full((h, w), 255, np.uint8)
        mask[h // 4: 3 * h // 4, w // 5: 4 * w // 5] = 0
        Image.fromarray(mask).save(tmp_path / "masks" / f"{name}.png")
    out = tmp_path / "out"
    demo.main(["--model-name", f"comodgan-{RES}", "--model-path", npz,
               "--images-dir", str(tmp_path / "images"),
               "--masks-dir", str(tmp_path / "masks"),
               "--output-dir", str(out), "--ch-base", str(CH_BASE),
               "--ch-max", str(CH_MAX), "--z-npy", z_npy,
               "--noise-mode", "const", "--device", "cpu"])

    forward, res = jc.load_comodgan_forward(
        f"comodgan-{RES}", npz, ch_base=CH_BASE, ch_max=CH_MAX,
        z=z.reshape(1, 512), noise_mode="const")
    assert res == RES
    for name in ("a", "b"):
        img = Image.open(tmp_path / "images" / f"{name}.png").convert("RGB")
        img_r = jpre.resize_max(img, max_size=RES)
        mask = jpre.read_mask(str(tmp_path / "masks" / f"{name}.png"))
        mask_r = jpre.resize_max(mask, max_size=RES,
                                 interpolation=Image.NEAREST)
        x = jpre.preprocess(img_r, mask_r, RES)
        result = np.asarray(forward(jnp.asarray(x)))[0]
        want = np.asarray(jpre.postprocess(result, img_r, mask_r),
                          np.int32)
        got = np.asarray(Image.open(out / f"{name}.png"), np.int32)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1, name


def test_demo_comodgan_z_npy_shape_validated(tmp_path):
    z_npy = str(tmp_path / "bad_z.npy")
    np.save(z_npy, np.zeros((4, 512), np.float32))   # per-image latents
    with pytest.raises(SystemExit, match="512"):
        demo.load_model(f"comodgan-{RES}", "/nonexistent.npz", "float32",
                        "cpu", z_npy=z_npy)
