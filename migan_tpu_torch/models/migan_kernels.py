"""The generator's forward through the hand-written kernels.

Port of `migan_tpu/models/migan_pallas.py:134-303` (`generator_apply_pallas`)
without its TPU layouts: no w-packed rows, no batch folding, no
phase-planar rgb, and no batch-size gate, so the kernels run at every
batch size. Call for call as on the TPU, the top `n = min(5, log2res - 4)`
levels run as kernels and the levels below as plain ops:

  encoder, each top level r   fused_block (conv1), fused_down_block (conv2)
  synthesis, each top level   fused_block with final_act=False (conv1's
                              low-res half; plain convs at the lowest of
                              these levels, as migan_pallas.py:253-258),
                              then fused_up_block (up-sample + skip + conv2
                              + torgb; features not stored at the top)

so one forward launches 2n-1 sepconv, n downblock and n upblock kernels:
9 + 5 + 5 for migan-512, 7 + 4 + 4 for migan-256. `fromrgb` stays a plain
1x1 conv and the rgb pyramid the plain `upsample2d`, as both are outside
the Pallas kernels in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

from ..ops import upsample2d
from ..ops.kernels import fused_block, fused_down_block, fused_up_block
from ..ops.kernels.sepconv import sepconv_plain
from .migan_inference import (
    ACT, Conv, Generator, GeneratorConfig, SeparableConv, conv1x1_apply,
    encoder_block_apply, generator_apply, resample_filter,
    synthesis_block_apply, synthesis_first_apply, _noise_for,
)


@dataclass(frozen=True)
class SepWeights:
    """A SeparableConv's weights in the kernels' layout, contiguous."""

    w_dw: torch.Tensor   # [3, 3, C]
    b_dw: torch.Tensor   # [C]
    w_pw: torch.Tensor   # [C, O]

    @classmethod
    def of(cls, p: SeparableConv) -> "SepWeights":
        return cls(p.conv1.weight[:, 0].permute(1, 2, 0).contiguous(),
                   p.conv1.bias.contiguous(),
                   p.conv2.weight[:, :, 0, 0].t().contiguous())


def kernel_levels(cfg: GeneratorConfig) -> List[int]:
    """Resolutions of the levels that run as kernels, top first."""
    top = cfg.encode_res[0]
    return [top >> i for i in range(max(0, min(5, cfg.log2res - 4)))]


def kernel_shapes(cfg: GeneratorConfig) -> List[Tuple]:
    """(kernel, H, W, C, O, final_act) of every launch of one
    `KernelGenerator` forward, in call order: H, W, C the input's size
    (x_lo's for upblock), O the output channels; final_act only for
    sepconv."""
    levels = kernel_levels(cfg)
    shapes = []
    for r in levels:
        shapes.append(("sepconv", r, r, cfg.ch(r), cfg.ch(r), True))
        shapes.append(("downblock", r, r, cfg.ch(r), cfg.ch(r // 2), None))
    for r in reversed(levels):
        h = r // 2
        if r != levels[-1]:
            shapes.append(("sepconv", h, h, cfg.ch(h), cfg.ch(r), False))
        shapes.append(("upblock", h, h, cfg.ch(r), cfg.ch(r), None))
    return shapes


def _torgb(p: Conv):
    return p.weight[:, :, 0, 0].t().contiguous(), p.bias.contiguous()


class KernelGenerator:
    """Forward of a `Generator` through the kernel chain.

    The kernels' weight copies, and the scaled noise planes at the model's
    own resolution, are made once, here: build it after the generator has
    its final device, dtype and weights.
    """

    def __init__(self, generator: Generator):
        cfg = generator.cfg
        self.generator = generator
        self.kernel_res = kernel_levels(cfg)
        self.n_kernel_levels = len(self.kernel_res)
        enc, syn = generator.encoder, generator.synthesis
        with torch.no_grad():
            self.enc = {r: (SepWeights.of(enc[f"b{r}"].conv1),
                            SepWeights.of(enc[f"b{r}"].conv2))
                        for r in self.kernel_res}
            self.syn = {r: (SepWeights.of(syn[f"b{r}"].conv1),
                            SepWeights.of(syn[f"b{r}"].conv2),
                            *_torgb(syn[f"b{r}"].torgb))
                        for r in self.kernel_res}
            self.noise = {r: self._noise(r, r, r) for r in self.kernel_res}

    def _noise(self, r: int, h: int, w: int):
        """Level r's two scaled noise planes at [h, w], contiguous."""
        p = self.generator.synthesis[f"b{r}"]
        dtype = p.conv1.noise_const.dtype
        return tuple(_noise_for(q, h, w).to(dtype).contiguous()
                     for q in (p.conv1, p.conv2))

    @torch.no_grad()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, H, W, 4] contiguous, of the generator's dtype and device
        -> [N, H, W, 3]."""
        g = self.generator
        cfg = g.cfg
        n = self.n_kernel_levels
        if n == 0:
            return generator_apply(g, x)
        f = resample_filter(x.device)
        enc, syn = g.encoder, g.synthesis
        top = self.kernel_res[0]

        # ---- encoder: kernel levels ------------------------------------
        z = ACT(conv1x1_apply(enc[f"b{top}"].fromrgb, x))
        feats: Dict[int, torch.Tensor] = {}
        for r in self.kernel_res:
            w1, w2 = self.enc[r]
            feats[r] = fused_block(z, w1.w_dw, w1.b_dw, w1.w_pw)
            z = fused_down_block(feats[r], w2.w_dw, w2.b_dw, w2.w_pw)

        # ---- encoder and synthesis below them: plain ops -----------------
        for r in cfg.encode_res[n:-1]:
            z, feats[r] = encoder_block_apply(enc[f"b{r}"], z, None, f,
                                              down=2)
        z, feats[4] = encoder_block_apply(enc["b4"], z, None, f, down=1)
        zz, img = synthesis_first_apply(syn["b4"], z, feats[4], f)
        for r in cfg.block_res[1:len(cfg.block_res) - n]:
            zz, img = synthesis_block_apply(syn[f"b{r}"], zz, img, feats[r],
                                            f)

        # ---- synthesis: kernel levels ----------------------------------
        for r in reversed(self.kernel_res):
            w1, w2, w_rgb, b_rgb = self.syn[r]
            if r == self.kernel_res[-1]:
                t = sepconv_plain(zz, w1.w_dw, w1.b_dw, w1.w_pw,
                                  final_act=False)
            else:
                t = fused_block(zz, w1.w_dw, w1.b_dw, w1.w_pw,
                                final_act=False)
            h, w = feats[r].shape[1:3]
            n1, n2 = (self.noise[r] if (h, w) == (r, r)
                      else self._noise(r, h, w))
            if r == top:
                rgb = fused_up_block(t, feats[r], n1, w2.w_dw, w2.b_dw,
                                     w2.w_pw, n2, w_rgb, b_rgb,
                                     emit_features=False)
            else:
                zz, rgb = fused_up_block(t, feats[r], n1, w2.w_dw, w2.b_dw,
                                         w2.w_pw, n2, w_rgb, b_rgb)
            img = upsample2d(img, f) + rgb
        return img
