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
noise_up.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

NUM_SMS = 132                # H100 SXM
MAX_SMEM_BYTES = 232_448     # dynamic shared memory a block may have
KC = 32                      # input channels per K chunk
CHANNEL_MULTIPLE = 8         # C and O: copied as 16-byte vectors


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


def smem_bytes(kernel: str, cfg: TileConfig, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block (see the module's docstring).
    x is, per stage, sepconv's three flat segments of tp + 2 pixels (rows
    h - 1, h, h + 1 of its taps), downblock's (2 th + 4) x (2 tw + 4)
    hi-res window, or upblock's (th/2 + 2) x (tw/2 + 2) x_lo window and
    (th + 2) x (tw + 2) skip window."""
    es = 4 if dtype == torch.float32 else 2
    a_row = KC + (4 if es == 4 else 8)
    ring = 2 * es * (cfg.tp * a_row + KC * (cfg.to + 8))
    if kernel == "sepconv":
        return ring + 2 * es * 3 * (cfg.tp + 2) * KC
    tw = cfg.tp // cfg.th
    if kernel == "upblock":
        x_window = (cfg.th // 2 + 2) * (tw // 2 + 2)
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
                dtype: torch.dtype) -> Plan:
    """The largest tile whose output width divides O and that still gives
    a full wave of NUM_SMS blocks; the smallest tile otherwise.

    kernel: "sepconv", "downblock" or "upblock"; n, h, w: the input's
    batch and spatial size (x_lo's for upblock); o: output channels. The input's channel count does not
    enter: it is streamed in chunks.
    """
    if kernel not in CONFIGS:
        raise ValueError(f"launch_plan: unknown kernel {kernel!r}")
    configs = CONFIGS[kernel]
    for i, cfg in enumerate(configs):
        out_tiles = _cdiv(o, cfg.to)
        blocks = pixel_tiles(kernel, n, h, w, cfg) * out_tiles
        if i == len(configs) - 1 or (o % cfg.to == 0 and blocks >= NUM_SMS):
            return Plan(i, blocks, cfg.threads,
                        smem_bytes(kernel, cfg, dtype), out_tiles)
    raise AssertionError("unreachable")


def check_tc_args(name: str, x: torch.Tensor, w_pw: torch.Tensor) -> None:
    """Raise on what the tensor-core kernels do not take: C or O not a
    multiple of 8, x or w_pw not 16-byte aligned (both are copied as
    16-byte vectors), or more than 2^31 - 1 pixels (32-bit pixel
    indices)."""
    n, h, w, c = x.shape
    o = w_pw.shape[-1]
    if c % CHANNEL_MULTIPLE or o % CHANNEL_MULTIPLE:
        raise ValueError(f"{name}: C = {c}, O = {o} channels; the kernel "
                         f"takes multiples of {CHANNEL_MULTIPLE}")
    if x.data_ptr() % 16 or w_pw.data_ptr() % 16:
        raise ValueError(f"{name}: x or w_pw is not 16-byte aligned")
    if n * h * w >= 2 ** 31:
        raise ValueError(f"{name}: {n * h * w} pixels, more than 2^31 - 1")
