"""The port's app pipeline (`migan_tpu_torch/export/pipeline.py`) against
`migan_tpu/export/pipeline.py` on the CPU, on seeded images and masks:
square and non-square, no hole, crops that shrink and crops that enlarge,
and a box clamped at the image's corner.

- The crop box is exactly equal.
- The generator input is within 1e-5, except where the bilinear resize
  lands on a .5 rounding tie (both sides round half to even, but their
  sums differ in the last bit): there it may differ by one uint8 step,
  2/255, and such elements are counted.
- `post` and `make_pipeline` (with the same generator weights, through
  the JAX generator and the port's plain one) are within 1 uint8: the
  composite truncates to uint8, so a last-bit difference can cross an
  integer.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from migan_tpu.export import pipeline as jpipe
from migan_tpu.io.checkpoint import save_npz as j_save_npz
from migan_tpu.models.migan_inference import (
    GeneratorConfig as JConfig, generator_apply as j_apply,
    generator_init as j_init,
)
from migan_tpu_torch.export import pipeline as pipe
from migan_tpu_torch.io import load_npz
from migan_tpu_torch.models.migan_inference import (
    GeneratorConfig, generator_apply,
)

RES = 64

# (name, (h, w), hole (y0, y1, x0, x1) or None, padding)
CASES = [
    ("square_shrink", (200, 200), (80, 120, 70, 130), 128),
    ("nonsquare_shrink", (150, 230), (40, 90, 100, 170), 128),
    ("no_hole", (120, 90), None, 128),
    ("enlarge", (40, 56), (10, 25, 20, 40), 128),
    ("corner_clamped", (300, 200), (5, 30, 150, 195), 32),
]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair(name, size, hole):
    rng = np.random.RandomState(sum(size))
    h, w = size
    img = rng.randint(0, 256, (1, h, w, 3)).astype(np.uint8)
    mask = np.full((1, h, w, 1), 255, np.uint8)
    if hole is not None:
        y0, y1, x0, x1 = hole
        mask[0, y0:y1, x0:x1] = np.where(rng.rand(y1 - y0, x1 - x0, 1) > .3,
                                         0, 255)
    return img, mask


@pytest.fixture(scope="module")
def generators(tmp_path_factory):
    jcfg = JConfig(resolution=RES, ch_base=4096)
    params = j_init(jax.random.PRNGKey(4), jcfg)
    path = str(tmp_path_factory.mktemp("w") / "w.npz")
    j_save_npz(path, params)
    g = load_npz(path, GeneratorConfig(resolution=RES, ch_base=4096))
    return (lambda x: j_apply(params, x, jcfg),
            lambda x: generator_apply(g, x))


def _u8_diff(a, b) -> int:
    return int(np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32))
               .max())


@pytest.mark.parametrize("name,size,hole,padding", CASES,
                         ids=[c[0] for c in CASES])
def test_stages_match_jax(name, size, hole, padding):
    img, mask = _pair(name, size, hole)
    j_pre, j_post = jpipe.make_pipeline_stages(RES, padding)
    pre, post = pipe.make_pipeline_stages(RES, padding, device="cpu")

    jx, jbox = (np.asarray(a) for a in j_pre(img, mask))
    x, box = pre(img, mask)
    np.testing.assert_array_equal(box.numpy(), jbox)
    assert x.shape == jx.shape == (1, RES, RES, 4)

    # elements whose resized value sits on a rounding tie
    t_box = tuple(torch.as_tensor(int(v)) for v in jbox)
    raw = pipe._crop_resize(torch.from_numpy(img), t_box, (RES, RES),
                            "linear").numpy()
    tie = np.abs(raw - np.floor(raw) - 0.5) < 1e-3
    tie = np.concatenate([np.zeros_like(tie[..., :1]), tie], axis=-1)
    err = np.abs(x.numpy() - jx)
    assert err[~tie].max(initial=0.0) <= 1e-5, name
    assert err[tie].max(initial=0.0) <= 2 / 255 + 1e-6, name
    print(f"{name}: {int(tie.sum())} tie elements, "
          f"{int((err[tie] > 1e-5).sum())} of them differ")

    out = np.random.RandomState(1).uniform(-1, 1, (1, RES, RES, 3)).astype(
        np.float32)
    want = np.asarray(j_post(img, mask, out, jbox))
    got = post(img, mask, out, box)
    assert got.dtype == torch.uint8 and got.shape == img.shape
    assert _u8_diff(got.numpy(), want) <= 1, name
    # outside the box the image is unchanged
    x_min, x_max, y_min, y_max = jbox
    outside = np.ones(img.shape[1:3], bool)
    outside[y_min:y_max, x_min:x_max] = False
    np.testing.assert_array_equal(got.numpy()[0][outside], img[0][outside])


@pytest.mark.parametrize("case", [CASES[1], CASES[3]],
                         ids=[CASES[1][0], CASES[3][0]])
def test_make_pipeline_matches_jax(generators, case):
    name, size, hole, padding = case
    img, mask = _pair(name, size, hole)
    j_gen, gen = generators
    want = np.asarray(jpipe.make_pipeline(j_gen, RES, padding)(img, mask))
    got = pipe.make_pipeline(gen, RES, padding, device="cpu")(img, mask)
    assert got.shape == want.shape == img.shape
    assert _u8_diff(got.numpy(), want) <= 1, name
    if hole is not None:   # the hole is painted
        y0, y1, x0, x1 = hole
        assert not np.array_equal(got.numpy()[0, y0:y1, x0:x1],
                                  img[0, y0:y1, x0:x1])


def test_gaussian_kernel_is_the_reference_formula():
    np.testing.assert_array_equal(pipe._gaussian_kernel(),
                                  jpipe._gaussian_kernel())


def test_pipeline_refuses_non_uint8():
    pre, _ = pipe.make_pipeline_stages(RES, device="cpu")
    with pytest.raises(TypeError, match="uint8"):
        pre(np.zeros((1, 8, 8, 3), np.float32),
            np.full((1, 8, 8, 1), 255, np.uint8))
