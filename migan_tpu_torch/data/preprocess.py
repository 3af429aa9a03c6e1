"""Host-side image/mask preprocessing with reference-demo semantics.

The port's own copy of `migan_tpu/data/preprocess.py` (numpy and PIL; cv2
for the resize back), so that the port imports nothing of `migan_tpu`.
It replicates the pre/post-processing of the reference demo CLI
(reference: scripts/demo.py:26-66,135-141), so outputs are comparable
pixel-for-pixel given the same weights:

  - mask channels collapsed (alpha preferred), binarize rule
    ``mask[mask < 255] = 0`` (anything not pure white is a hole),
    optional inversion *before* binarization.
  - images resized with PIL BICUBIC, masks with NEAREST.
  - model input x = concat([mask - 0.5, rgb * mask]) with rgb in [-1, 1],
    NHWC (the reference is NCHW).
  - output un-normalized to uint8, cv2 INTER_CUBIC resized back, composited
    ``img * m + result * (1 - m)``.
"""

from __future__ import annotations

import numpy as np
from PIL import Image


def read_mask(mask_path: str, invert: bool = False) -> Image.Image:
    """Load a mask as 8-bit L, 255=known 0=hole (reference demo.py:26-45)."""
    return read_mask_image(Image.open(mask_path), invert=invert)


def read_mask_image(mask: Image.Image, invert: bool = False) -> Image.Image:
    """`read_mask` on an already-open PIL image (the server decodes masks
    from request bytes instead of a path)."""
    mask = resize_max(mask, max_size=512, interpolation=Image.NEAREST)
    mask = np.array(mask)
    if mask.ndim == 3:
        if mask.shape[2] == 4:
            mask = np.dstack([mask[..., 3]] * 3)
        elif mask.shape[2] == 2:
            mask = np.dstack([mask[..., 1]] * 3)
        elif mask.shape[2] == 3:
            mask = np.dstack([mask[..., 0]] * 3)
    else:
        mask = np.dstack([mask, mask, mask])
    if invert:
        mask = 255 - mask
    mask[mask < 255] = 0
    return Image.fromarray(mask).convert("L")


def resize_max(image: Image.Image, max_size: int,
               interpolation=Image.BICUBIC) -> Image.Image:
    """Shrink so the larger side is <= max_size (reference demo.py:48-53)."""
    w, h = image.size
    if w > max_size or h > max_size:
        ratio = max_size / w if w > h else max_size / h
        image = image.resize((int(w * ratio), int(h * ratio)), interpolation)
    return image


def preprocess(img: Image.Image, mask: Image.Image,
               resolution: int) -> np.ndarray:
    """Build the 4-channel NHWC model input (reference demo.py:56-66)."""
    img = img.resize((resolution, resolution), Image.BICUBIC)
    mask = mask.resize((resolution, resolution), Image.NEAREST)
    img_np = np.array(img).astype(np.float32) * 2.0 / 255.0 - 1.0
    mask_np = (np.array(mask)[:, :, np.newaxis] // 255).astype(np.float32)
    x = np.concatenate([mask_np - 0.5, img_np * mask_np], axis=-1)
    return x[np.newaxis]  # [1, H, W, 4]


def postprocess(result_nhwc: np.ndarray, img_resized: Image.Image,
                mask_resized: Image.Image) -> Image.Image:
    """Un-normalize, resize back, composite (reference demo.py:135-141)."""
    import cv2

    result = np.clip(result_nhwc * 0.5 + 0.5, 0.0, 1.0) * 255
    result = result.astype(np.uint8)
    result = cv2.resize(result, dsize=img_resized.size,
                        interpolation=cv2.INTER_CUBIC)
    m = np.array(mask_resized)[:, :, np.newaxis] // 255
    composed = np.array(img_resized) * m + result * (1 - m)
    return Image.fromarray(composed.astype(np.uint8))
