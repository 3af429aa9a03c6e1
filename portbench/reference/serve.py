"""The resize mode of the inpainting service, written from the published
demo (Picsart-AI-Research/MI-GAN, `scripts/demo.py`): what one request
body must come back as, around the generator.

- The mask: alpha channel preferred, else the first; shrunk with NEAREST
  so its longer side is at most 512; anything below 255 is a hole.
- The image: shrunk with BICUBIC so its longer side is at most the
  model's resolution; the mask likewise with NEAREST.
- The input: both resized to the model's square (BICUBIC, NEAREST),
  concat(mask - 0.5, rgb * mask) with rgb in [-1, 1].
- The reply: the output clipped to [0, 255] as uint8 (truncating),
  resized back with OpenCV's INTER_CUBIC, and composited over the known
  pixels, as a PNG.
"""

from __future__ import annotations

import base64
import io
import json

import numpy as np
from PIL import Image


def shrink(image: Image.Image, max_size: int, resample) -> Image.Image:
    w, h = image.size
    if w > max_size or h > max_size:
        ratio = max_size / w if w > h else max_size / h
        image = image.resize((int(w * ratio), int(h * ratio)), resample)
    return image


def read_mask(mask: Image.Image) -> Image.Image:
    mask = np.array(shrink(mask, 512, Image.NEAREST))
    if mask.ndim == 3:
        mask = mask[..., {4: 3, 2: 1}.get(mask.shape[2], 0)]
    mask = mask.copy()
    mask[mask < 255] = 0
    return Image.fromarray(mask).convert("L")


def decode(body: bytes, res: int):
    """(x [1, res, res, 4] float32, image, mask) as the model sees them,
    image and mask at the reply's size."""
    payload = json.loads(body)
    img = Image.open(io.BytesIO(base64.b64decode(payload["image"])))
    img = img.convert("RGB")
    mask = Image.open(io.BytesIO(base64.b64decode(payload["mask"])))
    mask = read_mask(mask)
    img = shrink(img, res, Image.BICUBIC)
    mask = shrink(mask, res, Image.NEAREST)
    rgb = np.array(img.resize((res, res), Image.BICUBIC)).astype(
        np.float32) * 2.0 / 255.0 - 1.0
    m = (np.array(mask.resize((res, res), Image.NEAREST))[:, :, None]
         // 255).astype(np.float32)
    x = np.concatenate([m - 0.5, rgb * m], axis=-1)[None]
    return x, img, mask


def reply(out: np.ndarray, img: Image.Image, mask: Image.Image
          ) -> np.ndarray:
    """The composite [h, w, 3] uint8 for the generator's output
    [res, res, 3]."""
    import cv2

    result = (np.clip(out * 0.5 + 0.5, 0.0, 1.0) * 255).astype(np.uint8)
    result = cv2.resize(result, dsize=img.size,
                        interpolation=cv2.INTER_CUBIC)
    m = np.array(mask)[:, :, None] // 255
    return (np.array(img) * m + result * (1 - m)).astype(np.uint8)


def read_png(data: bytes) -> np.ndarray:
    return np.array(Image.open(io.BytesIO(data)).convert("RGB"))
