"""Composable per-image metric evaluators, psnr, ssim, lpips and null
(port of `migan_tpu/evalx/evaluators.py`; reference lib/evaluator/
eva_base.py:22-290 and its psnr / ssim / lpips / null plug-ins). Images
are NHWC, numpy arrays or tensors; results are numpy on the host.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

_EVALUATORS: Dict[str, type] = {}


def register(name: str):
    def deco(cls):
        _EVALUATORS[name] = cls
        return cls
    return deco


def get_evaluator(cfg) -> "base_evaluator":
    """A {type, args} config -> its evaluator; a list of them -> one
    `compose_evaluator` over all."""
    if isinstance(cfg, (list, tuple)):
        return compose_evaluator([_EVALUATORS[c["type"]](
            **c.get("args") or {}) for c in cfg])
    return _EVALUATORS[cfg["type"]](**cfg.get("args") or {})


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


class base_evaluator:
    symbol = "base"

    def __init__(self):
        self.final: Dict[str, float] = {}
        self.sample_n: Optional[int] = None

    def set_sample_n(self, n: int):
        self.sample_n = n

    def add_batch(self, pred, gt, fn=None, **kw):
        raise NotImplementedError

    def compute(self):
        raise NotImplementedError

    def one_line_summary(self) -> str:
        return " ".join(f"{k}={v:.4f}" for k, v in self.final.items())

    def clear_data(self):
        pass


class compose_evaluator(base_evaluator):
    """Several evaluators over the same batches (reference
    eva_base.py:245-290)."""

    def __init__(self, evaluators: List[base_evaluator]):
        super().__init__()
        self.evaluators = evaluators

    def set_sample_n(self, n):
        for e in self.evaluators:
            e.set_sample_n(n)

    def add_batch(self, pred, gt, fn=None, **kw):
        for e in self.evaluators:
            e.add_batch(pred, gt, fn=fn, **kw)

    def compute(self):
        out = {}
        for e in self.evaluators:
            e.compute()
            out.update(e.final)
        self.final = out
        return out

    def clear_data(self):
        for e in self.evaluators:
            e.clear_data()


@register("null")
class null_evaluator(base_evaluator):
    """reference lib/evaluator/eva_null.py."""

    symbol = "null"

    def add_batch(self, pred, gt, fn=None, **kw):
        pass

    def compute(self):
        self.final = {}
        return None


class _PerImage(base_evaluator):
    """Keeps one value per image; `compute` averages the first
    `sample_n`."""

    def __init__(self):
        super().__init__()
        self.vals: List[np.ndarray] = []

    def compute(self):
        v = np.concatenate(self.vals)[: self.sample_n]
        self.final[self.symbol] = float(v.mean())
        return self.final[self.symbol]

    def clear_data(self):
        self.vals = []


@register("psnr")
class psnr_evaluator(_PerImage):
    """reference lib/evaluator/eva_psnr.py:8-85, NHWC.

    An image equal to its ground truth has mse 0 and a PSNR of +inf
    (-10 log10(0)), as in the JAX package, and then so has the mean; the
    port computes that +inf without numpy's divide-by-zero warning."""

    symbol = "psnr"

    def __init__(self, for_dataset=None, scale=2, rgb_range=1):
        super().__init__()
        self.for_dataset = for_dataset
        self.scale = scale
        self.rgb_range = rgb_range

    def add_batch(self, pred, gt, fn=None, **kw):
        diff = (_np(pred) - _np(gt)) / self.rgb_range
        if self.for_dataset is None:
            valid = diff
        elif self.for_dataset == "benchmark":
            shave = self.scale
            gray = np.array([65.738, 129.057, 25.064]) / 256
            diff = (diff * gray[None, None, None, :]).sum(-1)
            valid = diff[:, shave:-shave, shave:-shave]
        elif self.for_dataset == "div2k":
            shave = self.scale + 6
            valid = diff[:, shave:-shave, shave:-shave, :]
        else:
            raise NotImplementedError(self.for_dataset)
        mse = (valid ** 2).mean(axis=tuple(range(1, valid.ndim)))
        with np.errstate(divide="ignore"):
            self.vals.append(-10 * np.log10(mse))


def _gaussian_window(window_size=11, sigma=1.5) -> np.ndarray:
    g = np.exp(-((np.arange(window_size) - window_size // 2) ** 2)
               / (2 * sigma ** 2))
    g = (g / g.sum()).astype(np.float32)
    return np.outer(g, g)


def ssim_nhwc(img1: torch.Tensor, img2: torch.Tensor,
              window_size: int = 11) -> torch.Tensor:
    """Gaussian-window SSIM per image, [N] (reference eva_ssim.py:21-41):
    depthwise convolutions with zero padding."""
    c = img1.shape[-1]
    w = torch.from_numpy(_gaussian_window(window_size)).to(img1)
    w = w.expand(c, 1, window_size, window_size)
    pad = window_size // 2

    def f(x):
        return F.conv2d(x, w, padding=pad, groups=c)

    x1, x2 = img1.permute(0, 3, 1, 2), img2.permute(0, 3, 1, 2)
    mu1, mu2 = f(x1), f(x2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    s1 = f(x1 * x1) - mu1_sq
    s2 = f(x2 * x2) - mu2_sq
    s12 = f(x1 * x2) - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mu1_mu2 + c1) * (2 * s12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return m.mean(dim=(1, 2, 3))


@register("ssim")
class ssim_evaluator(_PerImage):
    symbol = "ssim"

    def __init__(self, window_size=11):
        super().__init__()
        self.window_size = window_size

    @torch.no_grad()
    def add_batch(self, pred, gt, fn=None, **kw):
        self.vals.append(_np(ssim_nhwc(torch.as_tensor(pred),
                                       torch.as_tensor(gt),
                                       self.window_size)))


@register("lpips")
class lpips_evaluator(_PerImage):
    """reference lib/evaluator/eva_lpips.py:11-82, on [-1, 1] images
    (normalize=False, as the reference feeds it). `model`: an
    `evalx.lpips.LPIPS` with imported weights; None takes random ones
    (`lpips_init`), whose numbers mean nothing."""

    symbol = "lpips"

    def __init__(self, model=None, net="alex"):
        super().__init__()
        if net != "alex":
            raise ValueError(f"only the alex backbone is implemented, got "
                             f"{net!r}")
        from .lpips import lpips_init

        self.model = lpips_init(0) if model is None else model

    def add_batch(self, pred, gt, fn=None, **kw):
        dev = next(self.model.parameters()).device
        self.vals.append(_np(self.model(
            torch.as_tensor(pred).to(dev), torch.as_tensor(gt).to(dev),
            normalize=False)))
