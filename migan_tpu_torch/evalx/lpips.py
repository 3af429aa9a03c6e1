"""LPIPS perceptual distance with the AlexNet backbone (port of
`migan_tpu/evalx/lpips.py`; the `lpips.LPIPS(net='alex')` metric of the
reference evaluation, scripts/evaluate_fid_lpips.py:212-214): frozen
AlexNet conv features at 5 taps, per-channel unit normalisation, squared
differences, learned 1x1 heads, spatial mean, sum over taps.

`LPIPS` names its parameters as the lpips package does
(`net.slice1.0.weight`, ..., `lin0.model.1.weight`), so that package's
state_dict loads as it is (`import_lpips_state_dict`). Plain PyTorch on
cuDNN: the JAX package runs this in XLA, outside any Pallas kernel.
Inputs are NHWC, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# ImageNet scaling constants of the lpips package (ScalingLayer)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# AlexNet features: (features index, out, kernel, stride, pad); a 3x3
# stride-2 max-pool follows taps 0 and 1
_ALEX = [(0, 64, 11, 4, 2), (3, 192, 5, 1, 2), (6, 384, 3, 1, 1),
         (8, 256, 3, 1, 1), (10, 256, 3, 1, 1)]
# torchvision AlexNet.features index ranges of the lpips package's slices
_SLICES = [(0, 2), (2, 5), (5, 8), (8, 10), (10, 12)]


class _NetLinLayer(nn.Module):
    def __init__(self, chn: int):
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(),
                                   nn.Conv2d(chn, 1, 1, bias=False))


class LPIPS(nn.Module):
    """lpips-alex: forward(img0, img1) NHWC -> [N] distances."""

    def __init__(self):
        super().__init__()
        self.net = nn.Module()
        ic = 3
        convs = {idx: (oc, k, s, p) for idx, oc, k, s, p in _ALEX}
        for si, (lo, hi) in enumerate(_SLICES):
            sl = nn.Sequential()
            for idx in range(lo, hi):
                if idx in convs:
                    oc, k, s, p = convs[idx]
                    sl.add_module(str(idx), nn.Conv2d(ic, oc, k, s, p))
                    ic = oc
                elif idx in (2, 5):
                    sl.add_module(str(idx), nn.MaxPool2d(3, 2))
                else:
                    sl.add_module(str(idx), nn.ReLU())
            setattr(self.net, f"slice{si + 1}", sl)
        for i, (_, oc, _, _, _) in enumerate(_ALEX):
            setattr(self, f"lin{i}", _NetLinLayer(oc))
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1),
                             persistent=False)
        self.eval()

    def convs(self):
        """The five AlexNet convs, in order."""
        return [getattr(getattr(self.net, f"slice{si + 1}"), str(idx))
                for si, (idx, *_) in enumerate(_ALEX)]

    def heads(self):
        return [getattr(self, f"lin{i}").model[1] for i in range(5)]

    def _features(self, x: torch.Tensor):
        """The 5 relu taps; each conv's weights in x's dtype."""
        taps = []
        for i, conv in enumerate(self.convs()):
            x = F.relu(F.conv2d(x, conv.weight.to(x.dtype),
                                conv.bias.to(x.dtype), conv.stride,
                                conv.padding))
            taps.append(x)
            if i in (0, 1):
                x = F.max_pool2d(x, 3, 2)
        return taps

    @torch.no_grad()
    def forward(self, img0: torch.Tensor, img1: torch.Tensor, *,
                normalize: bool = True,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Per-image distance [N] of NHWC images; normalize=True takes
        inputs in [0, 1] (the reference evaluation passes it).

        compute_dtype=torch.bfloat16 runs the conv stack in bf16; the
        normalisation, differences and heads stay float32."""
        x0 = img0.permute(0, 3, 1, 2).float()
        x1 = img1.permute(0, 3, 1, 2).float()
        if normalize:
            x0, x1 = 2 * x0 - 1, 2 * x1 - 1
        x0 = (x0 - self.shift) / self.scale
        x1 = (x1 - self.shift) / self.scale
        if compute_dtype is not None:
            x0, x1 = x0.to(compute_dtype), x1.to(compute_dtype)
        total = 0.0
        for t0, t1, head in zip(self._features(x0), self._features(x1),
                                self.heads()):
            d = (_unit_normalize(t0.float()) - _unit_normalize(t1.float()))
            v = F.conv2d(d.square(), head.weight)
            total = total + v.mean(dim=(1, 2, 3))
        return total

    def jax_params(self) -> dict:
        """The JAX package's params of these weights, as numpy
        (`migan_tpu.evalx.lpips` layout: HWIO)."""
        params = {}
        for i, (conv, head) in enumerate(zip(self.convs(), self.heads())):
            params[f"conv{i}"] = {
                "weight": _hwio(conv.weight), "bias": _np(conv.bias)}
            params[f"lin{i}"] = {"weight": _hwio(head.weight)}
        return params


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(x.square(), dim=1, keepdim=True))
    return x / (norm + eps)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().float().numpy()


def _hwio(w: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(_np(w).transpose(2, 3, 1, 0))


def import_lpips_state_dict(sd: Mapping[str, np.ndarray]) -> LPIPS:
    """lpips.LPIPS(net='alex').state_dict() -> `LPIPS` (float32, CPU).
    The scaling layer's buffers, which are constants here, are ignored;
    every other key must match."""
    model = LPIPS()
    state = {k: torch.as_tensor(np.asarray(v, np.float32))
             for k, v in sd.items() if not k.startswith("scaling_layer.")}
    model.load_state_dict(state, strict=True)
    return model


def from_jax_params(params: Mapping) -> LPIPS:
    """The JAX package's LPIPS params (numpy or JAX arrays in its HWIO
    layout, as `lpips_init` or `import_lpips_state_dict` give them) ->
    `LPIPS`."""
    model = LPIPS()
    with torch.no_grad():
        for i, (conv, head) in enumerate(zip(model.convs(), model.heads())):
            p = params[f"conv{i}"]
            conv.weight.copy_(_oihw(p["weight"]))
            conv.bias.copy_(torch.tensor(np.asarray(p["bias"], np.float32)))
            head.weight.copy_(_oihw(params[f"lin{i}"]["weight"]))
    return model


def _oihw(w) -> torch.Tensor:
    return torch.tensor(np.asarray(w, np.float32).transpose(3, 2, 0, 1))


def lpips_init(seed: int = 1) -> LPIPS:
    """Random weights from `seed` (structure tests and smoke runs only),
    drawn as `migan_tpu.evalx.lpips.lpips_init` draws them: conv weights
    normal / sqrt(fan_in), biases zero, heads |normal| / C."""
    gen = torch.Generator().manual_seed(seed)
    model = LPIPS()
    with torch.no_grad():
        ic = 3
        for conv, head, (_, oc, k, _, _) in zip(model.convs(), model.heads(),
                                                _ALEX):
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen)
                              / math.sqrt(ic * k * k))
            conv.bias.zero_()
            head.weight.copy_(torch.randn(head.weight.shape,
                                          generator=gen).abs() / oc)
            ic = oc
    return model


def seeded_state_dict(seed: int) -> dict:
    """A random lpips-alex state_dict with the lpips package's key names
    and non-zero biases, from `seed` (for `.pth` files in tests and smoke
    runs)."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in LPIPS().state_dict().items():
        if k.startswith("lin"):
            sd[k] = torch.rand(v.shape, generator=gen) / v.shape[1]
        elif k.endswith(".weight"):
            sd[k] = torch.randn(v.shape, generator=gen) / math.sqrt(
                v[0].numel())
        else:
            sd[k] = 0.1 * torch.randn(v.shape, generator=gen)
    return sd
