"""The port's copy of the demo's pre/post-processing
(`migan_tpu_torch/data/preprocess.py`) gives exactly what
`migan_tpu/data/preprocess.py` gives, on the same seeded images and masks:
RGB and RGBA masks, inversion, shrinking of large inputs, and the
composite back."""

import numpy as np
import pytest
from PIL import Image

from migan_tpu.data import preprocess as ref
from migan_tpu_torch.data import preprocess as port


def _images(tmp_path, seed, size, mask_mode):
    rng = np.random.RandomState(seed)
    h, w = size
    img = Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8))
    hole = rng.rand(h, w) > 0.6
    m = np.where(hole, rng.randint(0, 255, (h, w)), 255).astype(np.uint8)
    planes = {"L": m, "LA": np.dstack([m // 2, m]),
              "RGB": np.dstack([m, m // 3, m]),
              "RGBA": np.dstack([m // 3, m // 3, m // 3, m])}[mask_mode]
    path = tmp_path / "mask.png"
    Image.fromarray(planes, mask_mode).save(path)
    return img, str(path)


@pytest.mark.parametrize("size,mask_mode,invert,res", [
    ((96, 80), "L", False, 64),
    ((300, 700), "RGB", True, 256),
    ((640, 520), "RGBA", False, 512),
    ((50, 60), "LA", True, 32),
])
def test_port_preprocess_equals_jax_package(tmp_path, size, mask_mode,
                                            invert, res):
    img, mask_path = _images(tmp_path, sum(size) + res, size, mask_mode)
    got_img = port.resize_max(img, max_size=res)
    want_img = ref.resize_max(img, max_size=res)
    np.testing.assert_array_equal(np.asarray(got_img), np.asarray(want_img))
    got_mask = port.resize_max(port.read_mask(mask_path, invert=invert),
                               max_size=res, interpolation=Image.NEAREST)
    want_mask = ref.resize_max(ref.read_mask(mask_path, invert=invert),
                               max_size=res, interpolation=Image.NEAREST)
    np.testing.assert_array_equal(np.asarray(got_mask),
                                  np.asarray(want_mask))
    x = port.preprocess(got_img, got_mask, res)
    assert x.shape == (1, res, res, 4) and x.dtype == np.float32
    np.testing.assert_array_equal(x, ref.preprocess(want_img, want_mask,
                                                    res))
    result = np.random.RandomState(res).randn(res, res, 3).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(port.postprocess(result, got_img, got_mask)),
        np.asarray(ref.postprocess(result, want_img, want_mask)))
