"""The Co-Mod-GAN forward's FLOPs, counted over the plain reference
(`reference/comodgan.py`) as `work.py` counts the MI-GAN generator's: a
multiply-add as 2, convolutions and products only, with
`torch.utils.flop_counter.FlopCounterMode` on the meta device. So the
count is the published model's work (its up-2 convs as transposed convs
at the low resolution), whatever the program computes in its place."""

from __future__ import annotations

import functools

import torch
from torch.utils.flop_counter import FlopCounterMode

from . import comodgan


@functools.lru_cache(maxsize=None)
def _flops(cfg_items: tuple) -> int:
    cfg = dict(cfg_items)
    with torch.device("meta"):
        state = {k: torch.empty(s)
                 for k, s in comodgan.param_shapes(cfg).items()}
        x = torch.empty(1, cfg["resolution"], cfg["resolution"], 4)
        z = torch.empty(1, cfg["z_dim"])
        with FlopCounterMode(display=False) as counter:
            comodgan.forward(cfg, state, x, z)
    return counter.get_total_flops()


def comodgan_flops(cfg: dict, images: int = 1) -> int:
    """FLOPs of the reference forward of `images` at the model's size
    (each image's work is its own: the count is linear in the batch)."""
    return _flops(tuple((k, cfg[k]) for k in comodgan.SHAPE_KEYS)) * images
