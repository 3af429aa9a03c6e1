"""The inpainting app pipeline in plain PyTorch around the MI-GAN
reference generator (`reference/generator.py`), written from the
published pipeline (Picsart-AI-Research/MI-GAN,
`scripts/create_onnx_pipeline.py`): what one photo and its mask must
come back as.

- The box: a square around the hole (the columns and rows with a pixel
  below 255), `padding` more on each side, at least the model's
  resolution, kept inside the photo and grown back where that cut it.
- The input: the box cut out of the photo and resized to the model's
  square bilinearly (half-pixel centres, edges clamped, no antialias),
  rounded back to uint8 as a uint8 resize does; the mask's box resized
  by legacy nearest (source floor(i * in / out)); both normalised into
  concat(mask - 0.5, rgb * mask), rgb in [-1, 1].
- The reply: the output scaled to [0, 255], resized bilinearly to the
  box's size and pasted into it, composited over the photo with the
  feathered mask (3x3 max-pool, then the published 5x5 blur with
  reflected edges), and truncated to uint8; outside the box the photo
  is unchanged.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import generator


def box(mask: np.ndarray, res: int, padding: int
        ) -> Tuple[int, int, int, int]:
    """(x_min, x_max, y_min, y_max) of the crop for mask [H, W] uint8,
    255 = known."""
    h, w = mask.shape
    hole = mask < 255
    cols, rows = np.flatnonzero(hole.any(axis=0)), np.flatnonzero(
        hole.any(axis=1))
    x_min, x_max = (int(cols[0]), int(cols[-1])) if len(cols) else (0, w)
    y_min, y_max = (int(rows[0]), int(rows[-1])) if len(rows) else (0, h)
    cx, cy = (x_min + x_max) // 2, (y_min + y_max) // 2
    crop = max(max(x_max - x_min, y_max - y_min) + 2 * padding, res)
    off = crop // 2
    x_min, x_max = max(cx - off, 0), min(cx + off, w)
    y_min, y_max = max(cy - off, 0), min(cy + off, h)
    xe, ye = max(crop - (x_max - x_min), 0), max(crop - (y_max - y_min), 0)
    return (max(x_min - xe, 0), min(x_max + xe, w), max(y_min - ye, 0),
            min(y_max + ye, h))


def _bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """NCHW float32 resized to `size` (align_corners False, no
    antialias)."""
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                         antialias=False)


def _blur_kernel(ksize: int = 5, sigma: float = 1.0) -> torch.Tensor:
    # the published formula as it is: exp(-((x - mean) / (2 sigma))^2)
    ax = torch.arange(ksize, dtype=torch.float64) - (ksize - 1) / 2.0
    g = torch.exp(-((ax / (2.0 * sigma)) ** 2))
    k = torch.outer(g, g)
    return (k / k.sum()).float()


def feather(mask: torch.Tensor) -> torch.Tensor:
    """[1, 1, H, W] float32 in 0..255 -> the composite's weight of the
    photo, 0..1: 3x3 max-pool, then the 5x5 blur with reflected edges."""
    m = F.max_pool2d(mask, 3, stride=1, padding=1)
    k = _blur_kernel().to(mask.device)[None, None]
    return F.conv2d(F.pad(m, [2, 2, 2, 2], mode="reflect"), k) / 255.0


@torch.no_grad()
def forward(cfg: dict, state: Dict[str, torch.Tensor], image: np.ndarray,
            mask: np.ndarray, padding: int, tf32: bool = False
            ) -> np.ndarray:
    """image [H, W, 3] uint8, mask [H, W] uint8 (255 = known) -> the
    composite [H, W, 3] uint8, computed on the state's device. tf32=True
    runs the generator as the control of lower precision."""
    dev = next(iter(state.values())).device
    res = cfg["resolution"]
    x0, x1, y0, y1 = box(mask, res, padding)
    img = torch.as_tensor(image).to(dev).permute(2, 0, 1)[None].float()
    m = torch.as_tensor(mask).to(dev)[None, None].float()
    crop = _bilinear(img[:, :, y0:y1, x0:x1], (res, res))
    crop = torch.round(crop.clamp(0.0, 255.0))
    ys = y0 + torch.arange(res, device=dev) * (y1 - y0) // res
    xs = x0 + torch.arange(res, device=dev) * (x1 - x0) // res
    mc = m[:, :, ys][:, :, :, xs] / 255.0
    x = torch.cat([mc - 0.5, (crop * (2.0 / 255.0) - 1.0) * mc], dim=1)
    out = generator.forward(cfg, state, x.permute(0, 2, 3, 1), tf32=tf32)
    out = ((out.permute(0, 3, 1, 2) * 0.5 + 0.5) * 255.0).clamp(0, 255)
    out = _bilinear(out, (y1 - y0, x1 - x0))
    wgt = feather(m)[:, :, y0:y1, x0:x1]
    part = img[:, :, y0:y1, x0:x1]
    comp = (part * wgt + out * (1.0 - wgt)).clamp(0, 255).to(torch.uint8)
    result = torch.as_tensor(image).to(dev).clone()
    result[y0:y1, x0:x1] = comp[0].permute(1, 2, 0)
    return result.cpu().numpy()
