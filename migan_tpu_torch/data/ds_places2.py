"""Places2 dataset and its loaders and formatters (the port's own copy of
`migan_tpu/data/ds_places2.py`; reference lib/data_factory/
ds_places2.py), numpy NHWC. Images leave a formatter as float32
[H, W, 3] in [-1, 1], masks as float32 [H, W], 1 = known.
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np
import PIL.Image

from .factory import ds_base, regdataset, regformat, regloader
from .masks import RandomMask

PIL.Image.MAX_IMAGE_PIXELS = None


@regdataset()
class places2(ds_base):
    """Walks <root_dir>/{train,val}_{256,512} (reference
    ds_places2.py:16-49); the uid from path tags."""

    def init_load_info(self, cfg):
        root_dir = cfg["root_dir"]
        tagging = {
            "train256": ("train_256", "train256"),
            "val256": ("val_256", "val256"),
            "train512": ("train_512", "train512"),
            "val512": ("val_512", "val512"),
        }
        self.load_info = []
        for m in cfg["mode"].split("+"):
            imdir, maintag = tagging[m]
            imdir = osp.join(root_dir, imdir)
            for subdir, _, files in sorted(os.walk(imdir)):
                for fi in sorted(files):
                    impath = osp.join(subdir, fi)
                    if not impath.endswith((".jpg", ".png")):
                        continue
                    tags = ([maintag] + subdir.split("/")[4:]
                            + [osp.splitext(fi)[0]])
                    self.load_info.append({
                        "unique_id": "-".join(tags),
                        "filename": fi,
                        "image_path": impath,
                    })


@regloader()
class DefaultLoader:
    """PIL -> float32 [H, W, 3] in [0, 1] (reference ds_places2.py:52-62)."""

    def __call__(self, element):
        img = PIL.Image.open(element["image_path"]).convert("RGB")
        element["image"] = np.asarray(img, np.float32) / 255.0
        return element


@regloader()
class FixResolutionLoader:
    def __init__(self, resolution=512):
        self.resolution = resolution

    def __call__(self, element):
        img = PIL.Image.open(element["image_path"]).convert("RGB")
        img = img.resize((self.resolution, self.resolution),
                         PIL.Image.BICUBIC)
        element["image"] = np.asarray(img, np.float32) / 255.0
        return element


def _bicubic_resize(x_hwc: np.ndarray, s: int) -> np.ndarray:
    """torch F.interpolate(mode='bicubic', align_corners=False): cv2's
    INTER_CUBIC has the same a = -0.75 kernel and half-pixel centers."""
    import cv2

    return cv2.resize(x_hwc, dsize=(s, s), interpolation=cv2.INTER_CUBIC)


@regformat()
class DefaultFormatter:
    """reference ds_places2.py:84-106 (lod always 0)."""

    def __init__(self, resolution=512):
        self.resolution = resolution

    def __call__(self, element, rng=np.random):
        x = (element["image"] - 0.5) * 2
        mask = RandomMask(self.resolution, rng=rng)
        return x, mask, element["unique_id"]


@regformat()
class CenterMaskFormatter:
    """reference ds_places2.py:109-124."""

    def __call__(self, element, rng=np.random):
        x = (element["image"] - 0.5) * 2
        h, w = x.shape[:2]
        latent = rng.randn(512).astype(np.float32)
        mask = np.ones([h, w], np.float32)
        mask[h // 4:(h // 4 + h // 2), w // 4:(w // 4 + w // 2)] = 0
        return x, latent, mask, element["unique_id"]


@regformat()
class FixedMaskFormatter:
    """reference ds_places2.py:131-148."""

    def __call__(self, element, rng=np.random):
        x = (element["image"] - 0.5) * 2
        latent = rng.randn(512).astype(np.float32)
        mpath = element["image_path"].replace("image/", "mask/").replace(
            ".png", "_mask.png")
        mask = (np.array(PIL.Image.open(mpath)) > 128).astype(np.float32)
        return x, latent, mask, element["unique_id"]


@regformat()
class AdvInpaintingFormatter:
    """Random scale and crop (reference ds_places2.py:155-179), with cv2's
    INTER_CUBIC for the reference's torch bicubic (the same kernel; they
    agree to ~1e-4 on [-1, 1] images). The draws (nh, nw, ch, cw, the
    mask) are in the reference's order."""

    def __init__(self, resolution=512, hole_range=(0, 1)):
        self.resolution = resolution
        self.hole_range = tuple(hole_range)

    def __call__(self, element, rng=np.random):
        import cv2

        x = (element["image"] - 0.5) * 2
        oh, ow = x.shape[:2]
        s = self.resolution
        nh = rng.randint(s, max(oh, int(s * 1.2)) + 1)
        nw = rng.randint(s, max(ow, int(s * 1.2)) + 1)
        ch = rng.randint(0, nh - s + 1)
        cw = rng.randint(0, nw - s + 1)
        x = cv2.resize(x, dsize=(nw, nh), interpolation=cv2.INTER_CUBIC)
        x = x[ch:ch + s, cw:cw + s]
        mask = RandomMask(s, self.hole_range, rng=rng)
        return x, mask, element["unique_id"]


@regformat()
class FreeFormMaskFormatter:
    """Bicubic resize -> [-1, 1] -> optional random flip -> RandomMask,
    the formatter of the shipped train and val configs (reference
    ds_places2.py:187-206, configs/dataset/places2.yaml).

    mask_backend: 'pil', the reference's generator (`data/masks.py`).
    'native', the JAX package's C++ rasterizer of the same algorithm, is
    not in the port yet (ROADMAP Queue 1) and raises.

    Flips and masks draw from `rng`: the DataLoader's per-item
    RandomState in its seed mode, else the global np.random stream.
    """

    def __init__(self, random_flip=True, resolution=512, hole_range=(0, 1),
                 mask_backend="pil"):
        if mask_backend != "pil":
            raise NotImplementedError(
                f"FreeFormMaskFormatter: mask_backend {mask_backend!r} is "
                "not in the port; the native mask rasterizer "
                "(data/fast_masks.py with native/maskgen.cpp) is ROADMAP "
                "Queue 1. Use mask_backend: pil.")
        self.random_flip = random_flip
        self.resolution = resolution
        self.hole_range = tuple(hole_range)

    def __call__(self, element, rng=np.random):
        s = self.resolution
        # the deterministic resize is memoized into cache_decoded elements
        x = element.get(f"_resized_{s}")
        if x is None:
            x = element["image"] * 2 - 1
            if x.shape[:2] != (s, s):
                x = _bicubic_resize(x, s)
            x = np.ascontiguousarray(x, np.float32)
            if element.get("_cache_derived"):
                element[f"_resized_{s}"] = x
        if self.random_flip and rng.rand() < 0.5:
            x = x[:, ::-1]
        mask = RandomMask(s, self.hole_range, rng=rng)
        # astype copies: callers never alias the cached array
        return x.astype(np.float32), mask, element["unique_id"]
