"""Launch geometry of the tensor-core kernels (`csrc/sepconv.cu`,
`csrc/downblock.cu`, `csrc/upblock.cu`).

Pure Python, so the CPU tests can check it for every main-path shape. The
block configurations and shared-memory sizes mirror
`csrc/pointwise_tc.cuh`; the C entry points check the plan they are given
and refuse one that does not match.

A block owns `tp` output pixels (sepconv: consecutive in the flat N*H*W
order; downblock: a `th` x `tp / th` tile of lo-res pixels; upblock: such
a tile of hi-res pixels) and `to` output channels, and streams the input channels in chunks of `KC`. The
grid is 1-D with the output tile fastest, so the blocks of one pixel tile
run together and share its input through L2.

Shared memory (`smem_bytes`) does not depend on C: two stages each of
the A operand [tp, KC], the weights [KC, to] (rows padded against bank
conflicts) and the kernel's stencil input (`x` below), plus downblock's
f32 y window and w-filtered rows, or upblock's f32 t window and its
noise_up. The options change the stencil input (`mode`): sepconv's skip
stages the skip window beside x; its prologue instead keeps the whole
[3 (tp + 2), Cin] input window in f32 for the block's life, so it grows
with Cin and a wide input can outgrow a block; upblock's phase input
stages four phase groups of the x_lo window.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

NUM_SMS = 132                # H100 SXM
MAX_SMEM_BYTES = 232_448     # dynamic shared memory a block may have
KC = 32                      # input channels per K chunk
CHANNEL_MULTIPLE = 8         # C and O: copied as 16-byte vectors
PROLOGUE_NARROW_CIN = 4      # the prologue's input may also be 4 wide

# `mode` of sepconv (the C entry point's argument): no option, skip, the
# pointwise prologue (with or without skip); of upblock: x_lo, or the
# four up-sampling phases of `ops/conv.py::pw_up2_phase` as x_lo.
SEP_PLAIN, SEP_SKIP, SEP_PROLOGUE = 0, 1, 2
UP_PLAIN, UP_PHASE = 0, 1


@dataclass(frozen=True)
class TileConfig:
    tp: int        # output pixels per block
    to: int        # output channels per block
    threads: int
    th: int        # downblock, upblock: tile rows


# Index = the `cfg` argument of the C entry points: SepCfg0-2, DownCfg0-2
# and UpCfg0-2 of pointwise_tc.cuh, largest tile first.
CONFIGS = {
    "sepconv": (TileConfig(64, 128, 256, 8), TileConfig(64, 64, 256, 8),
                TileConfig(16, 32, 128, 4)),
    "downblock": (TileConfig(64, 128, 512, 8), TileConfig(64, 64, 512, 8),
                  TileConfig(16, 32, 128, 4)),
    "upblock": (TileConfig(64, 128, 256, 8), TileConfig(64, 64, 256, 8),
                TileConfig(16, 64, 128, 4)),
}


@dataclass(frozen=True)
class Plan:
    config: int
    blocks: int
    threads: int
    smem_bytes: int
    out_tiles: int     # O / to, rounded up: blocks per pixel tile


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def smem_bytes(kernel: str, cfg: TileConfig, dtype: torch.dtype,
               mode: int = 0, cin: int = 0) -> int:
    """Dynamic shared memory of one block (see the module's docstring).
    x is, per stage, sepconv's three flat segments of tp + 2 pixels (rows
    h - 1, h, h + 1 of its taps), downblock's (2 th + 4) x (2 tw + 4)
    hi-res window, or upblock's (th/2 + 2) x (tw/2 + 2) x_lo window and
    (th + 2) x (tw + 2) skip window. mode: the kernel's option (SEP_*,
    UP_*); cin: the prologue's input channels."""
    es = 4 if dtype == torch.float32 else 2
    a_row = KC + (4 if es == 4 else 8)
    ring = 2 * es * (cfg.tp * a_row + KC * (cfg.to + 8))
    if kernel == "sepconv":
        window = 3 * (cfg.tp + 2)
        if mode == SEP_PROLOGUE:
            return ring + 4 * window * cin
        return ring + 2 * es * window * KC * (2 if mode == SEP_SKIP else 1)
    tw = cfg.tp // cfg.th
    if kernel == "upblock":
        x_window = (cfg.th // 2 + 2) * (tw // 2 + 2)
        if mode == UP_PHASE:
            x_window *= 4
        t_window = (cfg.th + 2) * (tw + 2)
        return (ring + 2 * es * (x_window + t_window) * KC
                + 4 * KC * t_window + 4 * t_window)
    yh, yw = 2 * cfg.th + 2, 2 * tw + 2
    x_window = (2 * cfg.th + 4) * (2 * tw + 4)
    return ring + 2 * es * x_window * KC + 4 * KC * (yh * yw + yh * tw)


def pixel_tiles(kernel: str, n: int, h: int, w: int, cfg: TileConfig) -> int:
    """Pixel tiles of one launch; h, w are the input's (hi-res for
    downblock, x_lo's for upblock)."""
    if kernel == "sepconv":
        return _cdiv(n * h * w, cfg.tp)
    tw = cfg.tp // cfg.th
    if kernel == "upblock":
        return n * _cdiv(2 * h, cfg.th) * _cdiv(2 * w, tw)
    return n * _cdiv(h // 2, cfg.th) * _cdiv(w // 2, tw)


def launch_plan(kernel: str, n: int, h: int, w: int, o: int,
                dtype: torch.dtype, mode: int = 0, cin: int = 0) -> Plan:
    """The largest tile whose output width divides O and that still gives
    a full wave of NUM_SMS blocks; the smallest tile otherwise. A tile
    whose shared memory does not fit a block is passed over; when none
    fits (sepconv's prologue at a wide input), it raises.

    kernel: "sepconv", "downblock" or "upblock"; n, h, w: the input's
    batch and spatial size (x_lo's for upblock); o: output channels;
    mode, cin: as `smem_bytes`. The input's channel count does not
    enter otherwise: it is streamed in chunks.
    """
    if kernel not in CONFIGS:
        raise ValueError(f"launch_plan: unknown kernel {kernel!r}")
    configs = CONFIGS[kernel]
    fits = [(i, cfg) for i, cfg in enumerate(configs)
            if smem_bytes(kernel, cfg, dtype, mode, cin) <= MAX_SMEM_BYTES]
    if not fits:
        raise ValueError(
            f"launch_plan: {kernel} mode {mode} with {cin} input channels "
            f"needs {smem_bytes(kernel, configs[-1], dtype, mode, cin)} "
            f"bytes of shared memory at its smallest tile, more than a "
            f"block's {MAX_SMEM_BYTES}")
    for i, cfg in fits:
        out_tiles = _cdiv(o, cfg.to)
        blocks = pixel_tiles(kernel, n, h, w, cfg) * out_tiles
        if i == fits[-1][0] or (o % cfg.to == 0 and blocks >= NUM_SMS):
            return Plan(i, blocks, cfg.threads,
                        smem_bytes(kernel, cfg, dtype, mode, cin),
                        out_tiles)
    raise AssertionError("unreachable")


def check_tc_args(name: str, x: torch.Tensor, w_pw: torch.Tensor,
                  prologue: bool = False) -> None:
    """Raise on what the tensor-core kernels do not take: x's channels,
    or w_pw's C or O, not a multiple of 8 (the input of sepconv's
    prologue may also have 4 channels, which it reads without 16-byte
    copies), x or w_pw not 16-byte aligned (both are copied as 16-byte
    vectors), or more than 2^31 - 1 pixels (32-bit pixel indices)."""
    n, h, w, c = x.shape
    ci, o = w_pw.shape[-2:]
    narrow = prologue and c == PROLOGUE_NARROW_CIN
    if ((c % CHANNEL_MULTIPLE and not narrow) or ci % CHANNEL_MULTIPLE
            or o % CHANNEL_MULTIPLE):
        raise ValueError(
            f"{name}: x has {c} channels, w_pw is {ci} -> {o}; the kernel "
            f"takes multiples of {CHANNEL_MULTIPLE}"
            + (f" (or an input of {PROLOGUE_NARROW_CIN} channels to the "
               f"prologue)" if prologue else
               f"; only the prologue's input may have "
               f"{PROLOGUE_NARROW_CIN}"))
    if x.data_ptr() % 16 or w_pw.data_ptr() % 16:
        raise ValueError(f"{name}: an input of shape {tuple(x.shape)} or "
                         f"w_pw is not 16-byte aligned")
    if n * h * w >= 2 ** 31:
        raise ValueError(f"{name}: {n * h * w} pixels, more than 2^31 - 1")
