"""Spatial (image-height) sharding of the generator forward on
`torch.distributed`: the port's counterpart of
`migan_tpu/parallel/mesh.py::spatial_sharding`.

The JAX package shards the H dim of an NHWC input over the mesh and calls
the plain jitted forward; GSPMD partitions every conv and FIR op along H
and inserts the halo exchanges of the stencils. Here each rank is a
process holding its block of rows, and the exchanges are explicit:

  - `shard_rows` / `gather_rows`: a rank's rows of a global NHWC tensor
    (the counterpart of `jax.device_put(x, spatial_sharding(mesh))`) and
    the inverse, an all-gather along H in rank order;
  - `halo_rows`: `k` rows from the rank above and the rank below by
    point-to-point sends (`dist.batch_isend_irecv`; NCCL on the card,
    gloo on the CPU), zero rows at the image's top and bottom edges,
    which is the zero padding of the one-process ops;
  - `generator_apply_spatial`: the plain forward of
    `models/migan_inference.py::generator_apply` on a rank's rows, with
    `RowStencils` in place of its one-process stencils, returning that
    rank's rows of the output (the output stays H-sharded).

Like the JAX function it mirrors, the sharded forward runs on plain ops
(cuDNN on the card), not on the kernel chain, which `load_model` keeps.
Without a process group it is the one-process forward on the whole image.

Halo arithmetic (`ops/upfirdn2d.py`'s padding, [1,3,3,1] filter, fh = 4):

  - dw 3x3, padding 1: output row i reads input rows i - 1 .. i + 1. One
    halo row each side, then no padding along H.
  - `downsample2d`, down 2: pads (fh - 1) // 2 = 1 row on top and
    (fh - 2) // 2 = 1 below, output row j reads input rows 2j - 1 ..
    2j + 2. A block starting at an even global row needs one halo row
    each side, then padding 0: `padding=(0, 0, -1, -1)` on top of the
    op's own.
  - `upsample2d`, up 2: zero-inserts (input row i at upsampled row 2i),
    pads (fh + 1) // 2 = 2 rows on top and (fh - 2) // 2 = 1 below;
    output row o reads upsampled rows o - 2 .. o + 1, i.e. input rows
    i - 1, i (o = 2i) and i, i + 1 (o = 2i + 1). With one halo row each
    side the upsampled block starts two rows early and ends with one
    zero row too many: `padding=(0, 0, -2, -2)`, i.e. H padding (0, -1).

Every other op (the 1x1 convs, bias, act, the skips' adds) is local.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..models import migan_inference as mi
from ..ops import conv2d, downsample2d, upsample2d
from . import mesh

# Extra H padding (x0, x1, y0, y1) that turns each resampling op's own
# zero padding into none once one halo row sits on each side (module
# docstring).
_DOWN_HALO_PAD = (0, 0, -1, -1)
_UP_HALO_PAD = (0, 0, -2, -2)


def shard_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's block of rows of a global NHWC `x`, blocks in rank
    order (the whole `x` without a process group). H must divide evenly
    over the ranks, as a mesh sharding's dim must."""
    world, h = mesh.world(), x.shape[1]
    if h % world:
        raise ValueError(f"{h} rows do not split evenly over {world} ranks")
    n = h // world
    return x[:, mesh.rank() * n:(mesh.rank() + 1) * n].contiguous()


def gather_rows(y: torch.Tensor) -> torch.Tensor:
    """The inverse of `shard_rows`: every rank's rows of `y` concatenated
    along H in rank order (each rank passes the same shape)."""
    if not mesh.is_initialized() or mesh.world() == 1:
        return y
    parts = [torch.empty_like(y) for _ in range(mesh.world())]
    dist.all_gather(parts, y.contiguous())
    return torch.cat(parts, dim=1)


def halo_rows(x: torch.Tensor, k: int = 1) -> torch.Tensor:
    """x [N, h, W, C] with the last `k` rows of the rank above on top and
    the first `k` rows of the rank below underneath: [N, h + 2k, W, C].
    The first and last ranks get zero rows at the image edge."""
    n, h, w, c = x.shape
    if not 0 < k <= h:
        raise ValueError(f"a halo of {k} rows from a block of {h}")
    above = x.new_zeros(n, k, w, c)
    below = x.new_zeros(n, k, w, c)
    r, world = mesh.rank(), mesh.world()
    ops = []
    if r > 0:
        ops += [dist.P2POp(dist.isend, x[:, :k].contiguous(), r - 1),
                dist.P2POp(dist.irecv, above, r - 1)]
    if r < world - 1:
        ops += [dist.P2POp(dist.isend, x[:, h - k:].contiguous(), r + 1),
                dist.P2POp(dist.irecv, below, r + 1)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return torch.cat([above, x, below], dim=1)


@dataclass(frozen=True)
class _Level:
    """One level of the resolution ladder: its global rows, and whether
    they are split over the ranks (each rank holds `local` rows from
    `offset`) or held whole by every rank."""

    rows: int
    sharded: bool

    @property
    def local(self) -> int:
        return self.rows // mesh.world() if self.sharded else self.rows

    @property
    def offset(self) -> int:
        return mesh.rank() * self.local if self.sharded else 0


class RowStencils(mi.Stencils):
    """`mi.Stencils` on this rank's block of rows of a global [N, h, w, C]
    input: the ops of `mi.generator_apply` that read neighbouring rows take
    them from the neighbouring ranks (module docstring), and the noise is
    this rank's rows of the global noise. A tensor's level is known by its
    width, which is not split: w * r / resolution at level r.

    The lowest levels: a level whose rows do not split evenly over the
    ranks (8 rows a rank at 64 over 8 ranks means 4 at the lowest level,
    half a row a rank) is gathered and run whole on every rank. A level
    splits evenly whenever the level below it does, so the sharded levels
    are the top ones, and the down-2 into a sharded level always finds an
    even count of local rows starting at an even global row."""

    def __init__(self, h: int, w: int, cfg: mi.GeneratorConfig):
        top = cfg.resolution
        self.levels = {w * r // top: _Level(h * r // top,
                                            (h * r // top) % mesh.world() == 0)
                       for r in cfg.block_res}

    def dw3x3(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if not self.levels[x.shape[2]].sharded:
            return super().dw3x3(x, w)
        return conv2d(halo_rows(x), w, padding=((0, 0), (1, 1)),
                      groups=x.shape[-1])

    def down(self, x: torch.Tensor, f: torch.Tensor,
             down: int = 2) -> torch.Tensor:
        assert down == 2, down
        lv, out = self.levels[x.shape[2]], self.levels[x.shape[2] // 2]
        if out.sharded:
            return downsample2d(halo_rows(x), f, padding=_DOWN_HALO_PAD)
        if lv.sharded:                # the last sharded level: gather it
            x = gather_rows(x)
        return downsample2d(x, f)

    def up(self, x: torch.Tensor, f: torch.Tensor,
           up: int = 2) -> torch.Tensor:
        assert up == 2, up
        lv, out = self.levels[x.shape[2]], self.levels[x.shape[2] * 2]
        if lv.sharded:
            return upsample2d(halo_rows(x), f, padding=_UP_HALO_PAD)
        y = upsample2d(x, f)
        return y[:, out.offset:out.offset + out.local].contiguous() \
            if out.sharded else y

    def noise(self, p: mi.SeparableConv, h: int, w: int) -> torch.Tensor:
        """The noise: `mi._noise_for` crops or tiles noise_const to the
        tensor it is given; under GSPMD the JAX forward tiles it to the
        level's GLOBAL height and each shard takes its rows. So the noise
        is made at the global size and this rank's rows [offset, offset +
        local) taken: a tiling to the local height h would give every rank
        the rows of the first."""
        lv = self.levels[w]
        return super().noise(p, lv.rows, w)[lv.offset:lv.offset + lv.local]


def generator_apply_spatial(generator: mi.Generator,
                            x_local: torch.Tensor) -> torch.Tensor:
    """`generator_apply` with the image's rows split over the ranks.

    x_local: this rank's rows [N, h, W, 4] of a global [N, h * world, W,
    4] input (`shard_rows`), of the generator's dtype and device; with
    NCCL the rank's card, with gloo the CPU. Returns this rank's rows
    [N, h, W, 3] of the output. The global H and W must be multiples of
    2**(log2(resolution) - 2), as the one-process forward needs."""
    cfg = generator.cfg
    step = cfg.resolution // 4
    n, h_local, w, _ = x_local.shape
    h = h_local * mesh.world()
    if h % step or w % step:
        raise ValueError(f"input {h}x{w} (global) is not a multiple of "
                         f"{step} in H and W, as migan-{cfg.resolution} "
                         "needs")
    if mesh.is_initialized() and x_local.device.type != \
            mesh.collective_device().type:
        raise ValueError(f"input on {x_local.device}, but the "
                         f"{mesh.backend()} group's tensors live on "
                         f"{mesh.collective_device()}")
    return mi.generator_apply(generator, x_local,
                              stencils=RowStencils(h, w, cfg))
