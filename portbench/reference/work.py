"""The work that the per-layer metrics divide by time: the generator's
FLOPs per image, the FLOPs and bytes that each fused op's math needs, and
the card's peaks (`peaks.json`).

FLOPs count a multiply-add as 2 and count convolutions and products only,
as `torch.utils.flop_counter.FlopCounterMode` does. For a fused op every
input byte is read once and every output byte written once, and each
depthwise tap, FIR tap and pointwise product is counted once, whatever
the kernel reads again or computes twice (the float32 product's three
TF32 passes count as one).
"""

from __future__ import annotations

import functools
import json
import math
from pathlib import Path
from typing import Optional, Sequence, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from . import generator

PEAKS = Path(__file__).with_name("peaks.json")
BYTES = {"float": 4, "float32": 4, "c10::BFloat16": 2, "bfloat16": 2,
         "c10::Half": 2, "float16": 2}
FIR_TAPS = 16          # the [1,3,3,1] filter's 4 x 4 taps


@functools.lru_cache(maxsize=None)
def _flops(cfg_items: tuple, batch: int) -> int:
    cfg = dict(cfg_items)
    with torch.device("meta"):
        state = {k: torch.empty(s)
                 for k, s in generator.param_shapes(cfg).items()}
        x = torch.empty(batch, cfg["resolution"], cfg["resolution"], 4)
        with FlopCounterMode(display=False) as counter:
            generator.forward(cfg, state, x)
    return counter.get_total_flops()


def generator_flops(cfg: dict, images: int = 1) -> int:
    """FLOPs of the reference forward of `images` at the model's size."""
    shape = tuple((k, cfg[k]) for k in generator.SHAPE_KEYS)
    return _flops(shape, 1) * images


def peaks(device_name: str) -> Optional[dict]:
    """The card's published peaks, or None for a card not in the table."""
    return json.loads(PEAKS.read_text())["cards"].get(device_name)


def peak_flops(card: dict, dtype: str) -> float:
    """The tensor-core rate that bounds a product of `dtype`: TF32's for
    float32 (the program runs its float32 products on the tensor cores)."""
    return card["flops"][{"float": "tf32", "float32": "tf32"}.get(dtype,
                                                                  "bf16")]


def _elems(shape: Sequence[int]) -> int:
    return math.prod(shape) if shape else 0


def sepconv_work(shapes, concrete, dtypes) -> Tuple[int, int]:
    """(FLOPs, bytes) of `migan::fused_block`: x [N,H,W,Cin], w_dw
    [3,3,C], b_dw [C], w_pw [C,O], noise [H,W]?, final_act, skip?,
    w_pre [Cin,C]?, b_pre [C]?."""
    n, h, w, cin = shapes[0]
    c, o = shapes[3]
    pix = n * h * w
    flops = 2 * pix * (9 * c + c * o)
    if shapes[7]:
        flops += 2 * pix * cin * c
    read = sum(_elems(shapes[i]) for i in (0, 1, 2, 3, 4, 6, 7, 8))
    return flops, (read + pix * o) * BYTES[dtypes[0]]


def downblock_work(shapes, concrete, dtypes) -> Tuple[int, int]:
    """(FLOPs, bytes) of `migan::fused_down_block`: x [N,Hh,Wh,C], w_dw,
    b_dw, w_pw [C,O] -> [N,Hh/2,Wh/2,O]."""
    n, hh, wh, c = shapes[0]
    o = shapes[3][1]
    lo = n * (hh // 2) * (wh // 2)
    flops = 2 * (n * hh * wh * 9 * c + lo * FIR_TAPS * c + lo * c * o)
    read = sum(_elems(shapes[i]) for i in range(4))
    return flops, (read + lo * o) * BYTES[dtypes[0]]


def upblock_work(shapes, concrete, dtypes) -> Tuple[int, int]:
    """(FLOPs, bytes) of `migan::fused_up_block`: x_lo [N,Hl,Wl,C or 4C],
    skip [N,2Hl,2Wl,C], noise_up, w_dw, b_dw, w_pw [C,O], noise2?,
    w_rgb [O,3]?, b_rgb?, emit_features, phase_input. The up-sampling
    counts the 4 FIR taps that reach each hi-res pixel (none with the
    phase input, which is already up-sampled)."""
    n, hi_h, hi_w, c = shapes[1]
    o = shapes[5][1]
    emit, phase = bool(concrete[9]), bool(concrete[10])
    pix = n * hi_h * hi_w
    flops = 2 * pix * (9 * c + c * o)
    if not phase:
        flops += 2 * pix * 4 * c
    out = pix * o if emit else 0
    if shapes[7]:
        flops += 2 * pix * o * 3
        out += pix * 3
    read = sum(_elems(shapes[i]) for i in range(9))
    return flops, (read + out) * BYTES[dtypes[0]]


OPS = {"migan::fused_block": sepconv_work,
       "migan::fused_down_block": downblock_work,
       "migan::fused_up_block": upblock_work}


def bound_seconds(card: dict, op: str, shapes, concrete, dtypes) -> float:
    """The least time the card could take for one call: the larger of its
    bytes over the memory bandwidth and its FLOPs over the tensor peak."""
    flops, nbytes = OPS[op](shapes, concrete, dtypes)
    return max(nbytes / card["hbm_bytes_per_s"],
               flops / peak_flops(card, dtypes[0]))
