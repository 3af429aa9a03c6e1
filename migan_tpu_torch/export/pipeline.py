"""The inpainting app pipeline in PyTorch on the device (port of
`migan_tpu/export/pipeline.py`; reference scripts/create_onnx_pipeline.py
:119-264): crop a square box around the hole (padding 128, at least the
model's resolution), resize it to the model's resolution, normalise, run
the generator, resize its output back into the box, and composite with a
feathered mask (3x3 max-pool, then the reference's 5x5 gaussian blur).

The box depends on the data, so, as in JAX, the crop and the paste are
resamplings with a computed scale and translation (`ops/resize.py`), and
the image keeps its full size throughout; only the box's pixels change.

I/O as the reference: uint8 RGB image [1, H, W, 3] and uint8 mask
[1, H, W, 1] with 255 = known, as numpy arrays or tensors; the result is
a uint8 [1, H, W, 3] tensor on the pipeline's device.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import scale_and_translate


def _gaussian_kernel(ksize: int = 5, sigma: float = 1.0) -> np.ndarray:
    # The reference's GaussianSmoothing formula as it is
    # (create_onnx_pipeline.py:81-87): exp(-((x - mean) / (2 sigma))**2),
    # an effective stddev of sigma * sqrt(2), not the textbook
    # exp(-x^2 / (2 sigma^2)). The numbers are the parity spec.
    ax = np.arange(ksize) - (ksize - 1) / 2.0
    g = np.exp(-((ax / (2.0 * sigma)) ** 2))
    k = np.outer(g, g)
    return (k / k.sum()).astype(np.float32)


def _reflect_pad_blur(mask: torch.Tensor, ksize: int = 5,
                      sigma: float = 1.0) -> torch.Tensor:
    """Gaussian blur with reflect padding of [1, H, W, 1] float32."""
    pad = ksize // 2
    k = torch.from_numpy(_gaussian_kernel(ksize, sigma)).to(mask.device,
                                                            mask.dtype)
    x = F.pad(mask.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode="reflect")
    return F.conv2d(x, k[None, None]).permute(0, 2, 3, 1)


def _maxpool3(mask: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 max-pool of [1, H, W, 1], padded with -inf."""
    return F.max_pool2d(mask.permute(0, 3, 1, 2), 3, stride=1,
                        padding=1).permute(0, 2, 3, 1)


def get_masked_bbox(mask: torch.Tensor, res: int, padding: int,
                    h: int, w: int):
    """Square crop box covering the hole, padded and clamped
    (reference create_onnx_pipeline.py:132-231). mask: [1, H, W, 1] uint8,
    255 = known. Returns (x_min, x_max, y_min, y_max) as 0-dim int64
    tensors on the mask's device."""
    m = mask[0, :, :, 0].to(torch.float32)
    xx = m.mean(dim=0)        # [W] column means
    yy = m.mean(dim=1)        # [H] row means
    w_idx = torch.arange(w, device=m.device)
    h_idx = torch.arange(h, device=m.device)
    big_w, big_h = torch.full_like(w_idx, w), torch.full_like(h_idx, h)
    x_min = torch.where(xx < 255.0, w_idx, big_w).min()
    x_max = torch.where(xx < 255.0, w_idx, torch.zeros_like(w_idx)).max()
    y_min = torch.where(yy < 255.0, h_idx, big_h).min()
    y_max = torch.where(yy < 255.0, h_idx, torch.zeros_like(h_idx)).max()
    # no hole: x_min = w > x_max = 0; the reference forces min <= max
    x_min, x_max = torch.minimum(x_min, x_max), torch.maximum(x_min, x_max)
    y_min, y_max = torch.minimum(y_min, y_max), torch.maximum(y_min, y_max)

    cnt_x = (x_min + x_max) // 2
    cnt_y = (y_min + y_max) // 2
    crop_size = torch.maximum(x_max - x_min, y_max - y_min) + 2 * padding
    crop_size = crop_size.clamp(min=res)

    offset = crop_size // 2
    x_min = (cnt_x - offset).clamp(min=0)
    x_max = (cnt_x + offset).clamp(max=w)
    y_min = (cnt_y - offset).clamp(min=0)
    y_max = (cnt_y + offset).clamp(max=h)

    x_excess = (crop_size - (x_max - x_min)).clamp(min=0)
    y_excess = (crop_size - (y_max - y_min)).clamp(min=0)
    x_min = (x_min - x_excess).clamp(min=0)
    x_max = (x_max + x_excess).clamp(max=w)
    y_min = (y_min - y_excess).clamp(min=0)
    y_max = (y_max + y_excess).clamp(max=h)
    return x_min, x_max, y_min, y_max


def _crop_resize(img: torch.Tensor, box, out_hw: Tuple[int, int],
                 method: str) -> torch.Tensor:
    """Resize the box of [1, H, W, C] to out_hw; float32 out."""
    oh, ow = out_hw
    x_min, x_max, y_min, y_max = box
    if method == "nearest":
        # torchvision-legacy nearest, src = floor(dst * size_in / size_out),
        # as a gather
        H, W = img.shape[1], img.shape[2]
        ys = y_min + (torch.arange(oh, device=img.device)
                      * (y_max - y_min)) // oh
        xs = x_min + (torch.arange(ow, device=img.device)
                      * (x_max - x_min)) // ow
        out = img.index_select(1, ys.clamp(0, H - 1))
        return out.index_select(2, xs.clamp(0, W - 1)).to(torch.float32)
    x_min, x_max, y_min, y_max = (b.to(torch.float32) for b in box)
    sy, sx = oh / (y_max - y_min), ow / (x_max - x_min)
    # antialias off, as the reference's torch bilinear resize
    return scale_and_translate(img.to(torch.float32), out_hw, (sy, sx),
                               (-y_min * sy, -x_min * sx), antialias=False)


def _paste_resize(small: torch.Tensor, box, out_hw: Tuple[int, int]
                  ) -> torch.Tensor:
    """Inverse of _crop_resize: scale [1, res, res, C] into the box of a
    full-size canvas (values outside the box are masked off later)."""
    x_min, x_max, y_min, y_max = (b.to(torch.float32) for b in box)
    sh = (y_max - y_min) / small.shape[1]
    sw = (x_max - x_min) / small.shape[2]
    return scale_and_translate(small, out_hw, (sh, sw), (y_min, x_min),
                               antialias=False)


def make_pipeline_stages(resolution: int, padding: int = 128,
                         device="cuda"):
    """(pre, post): the pipeline's halves around a generator forward that
    the caller dispatches. Its [N, res, res, 4] input does not depend on
    the image's size, so a server batches the forwards of concurrent
    requests of any sizes while pre and post run per request
    (`cli/serve.py::PipelineRunner`); `make_pipeline` chains the three."""
    device = torch.device(device)

    def _u8(a) -> torch.Tensor:
        t = torch.as_tensor(a).to(device)
        if t.dtype != torch.uint8:
            raise TypeError(f"pipeline: expected uint8, got {t.dtype}")
        return t

    @torch.no_grad()
    def pre(image, mask):
        """uint8 [1, H, W, 3] + [1, H, W, 1] -> (generator input
        [1, res, res, 4] float32, box [4] int64: x_min, x_max, y_min,
        y_max)."""
        image, mask = _u8(image), _u8(mask)
        H, W = image.shape[1], image.shape[2]
        box = get_masked_bbox(mask, resolution, padding, H, W)
        img_s = _crop_resize(image, box, (resolution, resolution), "linear")
        # the reference resizes the uint8 tensor, which rounds back to
        # uint8 before normalising (round half to even, as jnp.round)
        img_s = torch.round(img_s.clamp(0.0, 255.0))
        mask_s = _crop_resize(mask, box, (resolution, resolution), "nearest")
        img_n = img_s * (2.0 / 255.0) - 1.0
        mask_n = mask_s / 255.0
        x = torch.cat([mask_n - 0.5, img_n * mask_n], dim=-1)
        return x, torch.stack(box)

    @torch.no_grad()
    def post(image, mask, out, box4) -> torch.Tensor:
        """Generator output [1, res, res, 3] in [-1, 1] and pre()'s box ->
        composited uint8 [1, H, W, 3] at the image's size."""
        image, mask = _u8(image), _u8(mask)
        out = torch.as_tensor(out).to(device, torch.float32)
        box4 = torch.as_tensor(box4).to(device)
        H, W = image.shape[1], image.shape[2]
        box = (box4[0], box4[1], box4[2], box4[3])
        out = ((out * 0.5 + 0.5) * 255.0).clamp(0, 255)
        out_full = _paste_resize(out, box, (H, W))
        # feathered composite at the image's own scale
        # (reference postprocess, create_onnx_pipeline.py:241-250)
        m = _reflect_pad_blur(_maxpool3(mask.to(torch.float32))) / 255.0
        img_f = image.to(torch.float32)
        composed = (img_f * m + out_full * (1.0 - m)).clamp(0, 255)
        # only the box changes (the reference pastes into a slice)
        x_min, x_max, y_min, y_max = box
        yy = torch.arange(H, device=device)[None, :, None, None]
        xx = torch.arange(W, device=device)[None, None, :, None]
        region = ((yy >= y_min) & (yy < y_max)
                  & (xx >= x_min) & (xx < x_max))
        # float -> uint8 truncates, as JAX's astype
        return torch.where(region, composed, img_f).to(torch.uint8)

    return pre, post


class Pipeline(nn.Module):
    """pipeline(image_u8 [1, H, W, 3], mask_u8 [1, H, W, 1]) -> uint8
    [1, H, W, 3] tensor on its device: `make_pipeline_stages`' halves
    around the generator. A module, so that `torch.export` takes it whole
    with the generator's weights (`cli/create_pipeline.py`)."""

    def __init__(self, generator_fn: Callable[[torch.Tensor], torch.Tensor],
                 resolution: int, padding: int = 128, device="cuda"):
        super().__init__()
        self.generator = generator_fn
        self.pre, self.post = make_pipeline_stages(resolution, padding,
                                                   device)

    def forward(self, image, mask) -> torch.Tensor:
        x, box4 = self.pre(image, mask)
        return self.post(image, mask, self.generator(x), box4)


def make_pipeline(generator_fn: Callable[[torch.Tensor], torch.Tensor],
                  resolution: int, padding: int = 128,
                  device="cuda") -> Pipeline:
    """pipeline(image_u8 [1, H, W, 3], mask_u8 [1, H, W, 1]) -> uint8
    [1, H, W, 3] tensor on `device`.

    generator_fn: [1, res, res, 4] float32 tensor on `device` ->
    [1, res, res, 3] in [-1, 1] (the `forward` of `cli.demo.load_model`).
    """
    return Pipeline(generator_fn, resolution, padding, device)
