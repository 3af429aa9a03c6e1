"""Re-parametrization fold: training generator -> deploy generator (port
of `migan_tpu/export/fold.py`; reference
scripts/export_inference_model.py:17-85).

Each conv's re-param sum and forward-time weight norm become one static
weight, ``(sum_i w_i / sqrt(N)) * rsqrt(sum(w^2) + 1e-8)``. The noise
buffers move from the training SeparableConv's pointwise conv
(`...conv1.conv2.noise_const`) up to the deploy SeparableConv
(`...conv1.noise_const`). Only the depthwise training topology folds into
the deploy net, as in the reference.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..models import migan
from ..models.migan_inference import (Generator, GeneratorConfig,
                                      generator_apply)


def _fold_conv(layer: migan.ConvLayer, prefix: str,
               out: Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.weight"] = layer.effective_weight()
    if layer.bias is not None:
        out[f"{prefix}.bias"] = layer.bias


def _fold_sep(sep: migan.SeparableConv, prefix: str,
              out: Dict[str, torch.Tensor]) -> None:
    _fold_conv(sep.conv1, f"{prefix}.conv1", out)
    _fold_conv(sep.conv2, f"{prefix}.conv2", out)
    if sep.conv2.use_noise:
        out[f"{prefix}.noise_const"] = sep.conv2.noise_const
        out[f"{prefix}.noise_strength"] = sep.conv2.noise_strength


@torch.no_grad()
def fold_generator(train_g: migan.Generator) -> Generator:
    """A training `Generator` (depthwise topology) -> the deploy
    `Generator` of the same resolution, float32, on train_g's device."""
    cfg = train_g.cfg
    if not cfg.depthwise:
        raise ValueError("only the depthwise training topology folds into "
                         "the deploy net (as in the reference)")
    state: Dict[str, torch.Tensor] = {}
    for part in ("encoder", "synthesis"):
        for name, block in getattr(train_g, part).items():
            prefix = f"{part}.{name}"
            for layer in ("conv1", "conv2"):
                _fold_sep(getattr(block, layer), f"{prefix}.{layer}", state)
            for layer in ("fromrgb", "torgb"):
                if hasattr(block, layer):
                    _fold_conv(getattr(block, layer), f"{prefix}.{layer}",
                               state)
    g = Generator(GeneratorConfig(resolution=cfg.resolution, ic_n=cfg.ic_n,
                                  rgb_n=cfg.rgb_n, ch_base=cfg.ch_base,
                                  ch_max=cfg.ch_max))
    device = next(train_g.parameters()).device
    g.load_state_dict({k: v.detach().to(torch.float32)
                       for k, v in state.items()}, strict=True)
    return g.to(device)


def diff_count(original: torch.Tensor, converted: torch.Tensor) -> int:
    """Elements where the training net's output and the folded net's
    disagree: ``~np.isclose(rtol=1e-3)`` with numpy's default atol
    (reference export_inference_model.py:132-164)."""
    a, b = (t.detach().float().cpu().numpy() for t in (original, converted))
    return int((~np.isclose(a, b, rtol=1e-3)).sum())


def fold_diff_statistic(train_g: migan.Generator,
                        x: torch.Tensor) -> float:
    """% of output elements, per image and res² (as the reference counts
    them), where train-G in `const` noise mode and the folded deploy net
    (its plain forward, as in the reference and the JAX package)
    disagree (:func:`diff_count`)."""
    folded = fold_generator(train_g).eval()
    with torch.no_grad():
        want = migan.generator_apply(train_g, x, noise_mode="const")
        got = generator_apply(folded, x)
    res = train_g.cfg.resolution
    return diff_count(want, got) / x.shape[0] / res ** 2 * 100
