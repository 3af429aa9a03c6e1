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

from typing import Dict, List, Tuple

import torch
from torch import nn

from ..ops import upsample2d
from ..ops.kernels import fused_block, fused_down_block, fused_up_block
from ..ops.kernels.sepconv import sepconv_plain
from ..utils import tracing
from .migan_inference import (
    ACT, EncoderBlock, Generator, GeneratorConfig, SeparableConv,
    SynthesisBlock, conv1x1_apply, encoder_block_apply, generator_apply,
    resample_filter, synthesis_block_apply, synthesis_first_apply,
    _noise_for,
)


class SepWeights(nn.Module):
    """A SeparableConv's weights in the kernels' layout, as contiguous
    buffers (copies; the generator's parameters stay as they are)."""

    def __init__(self, p: SeparableConv):
        super().__init__()
        self.register_buffer("w_dw",          # [3, 3, C]
                             p.conv1.weight[:, 0].permute(1, 2, 0).clone(
                                 memory_format=torch.contiguous_format))
        self.register_buffer("b_dw", p.conv1.bias.clone())           # [C]
        self.register_buffer("w_pw",          # [C, O]
                             p.conv2.weight[:, :, 0, 0].t().contiguous())


class _EncoderLevel(nn.Module):
    """An encoder kernel level: conv1 and conv2 (`SepWeights`)."""

    def __init__(self, p: EncoderBlock):
        super().__init__()
        self.conv1, self.conv2 = SepWeights(p.conv1), SepWeights(p.conv2)


class _SynthesisLevel(nn.Module):
    """A synthesis kernel level: conv1, conv2 (`SepWeights`), torgb's
    w_rgb [O, 3] and b_rgb [3], and the two scaled noise planes at the
    level's own resolution."""

    def __init__(self, p: SynthesisBlock, noise):
        super().__init__()
        self.conv1, self.conv2 = SepWeights(p.conv1), SepWeights(p.conv2)
        self.register_buffer("w_rgb", p.torgb.weight[:, :, 0, 0].t()
                             .contiguous())
        self.register_buffer("b_rgb", p.torgb.bias.clone())
        self.register_buffer("noise1", noise[0])
        self.register_buffer("noise2", noise[1])


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


class KernelGenerator(nn.Module):
    """Forward of a `Generator` through the kernel chain, as a module.

    The kernels' weight copies, and the scaled noise planes at the model's
    own resolution, are registered buffers made once, here: build it
    after the generator has its final device, dtype and weights. Being a
    module, it is what `torch.export` takes (`export/torch_export.py`).

    Spans (`utils/tracing.py`): `generator.forward`, and inside it
    `generator.fromrgb`, `generator.enc.b<r>` for each kernel level,
    `generator.plain` (the levels below the kernels) and
    `generator.syn.b<r>` for each kernel level.
    """

    def __init__(self, generator: Generator):
        super().__init__()
        cfg = generator.cfg
        self.generator = generator
        self.kernel_res = kernel_levels(cfg)
        self.n_kernel_levels = len(self.kernel_res)
        self.span_names = {r: (f"generator.enc.b{r}", f"generator.syn.b{r}")
                           for r in self.kernel_res}
        enc, syn = generator.encoder, generator.synthesis
        with torch.no_grad():
            self.enc_levels = nn.ModuleDict({
                f"b{r}": _EncoderLevel(enc[f"b{r}"]) for r in self.kernel_res})
            self.syn_levels = nn.ModuleDict({
                f"b{r}": _SynthesisLevel(syn[f"b{r}"], self._noise(r, r, r))
                for r in self.kernel_res})

    def _noise(self, r: int, h: int, w: int):
        """Level r's two scaled noise planes at [h, w], contiguous."""
        p = self.generator.synthesis[f"b{r}"]
        dtype = p.conv1.noise_const.dtype
        return tuple(_noise_for(q, h, w).to(dtype).contiguous()
                     for q in (p.conv1, p.conv2))

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, H, W, 4] contiguous, of the generator's dtype and device
        -> [N, H, W, 3]."""
        with tracing.span("generator.forward"):
            return self._forward(x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.generator
        cfg = g.cfg
        n = self.n_kernel_levels
        if n == 0:
            return generator_apply(g, x)
        f = resample_filter(x.device)
        enc, syn = g.encoder, g.synthesis
        top = self.kernel_res[0]

        # ---- encoder: kernel levels ------------------------------------
        with tracing.span("generator.fromrgb"):
            z = ACT(conv1x1_apply(enc[f"b{top}"].fromrgb, x))
        feats: Dict[int, torch.Tensor] = {}
        for r in self.kernel_res:
            q = self.enc_levels[f"b{r}"]
            w1, w2 = q.conv1, q.conv2
            with tracing.span(self.span_names[r][0]):
                feats[r] = fused_block(z, w1.w_dw, w1.b_dw, w1.w_pw)
                z = fused_down_block(feats[r], w2.w_dw, w2.b_dw, w2.w_pw)

        # ---- encoder and synthesis below them: plain ops -----------------
        with tracing.span("generator.plain"):
            for r in cfg.encode_res[n:-1]:
                z, feats[r] = encoder_block_apply(enc[f"b{r}"], z, None, f,
                                                  down=2)
            z, feats[4] = encoder_block_apply(enc["b4"], z, None, f, down=1)
            zz, img = synthesis_first_apply(syn["b4"], z, feats[4], f)
            for r in cfg.block_res[1:len(cfg.block_res) - n]:
                zz, img = synthesis_block_apply(syn[f"b{r}"], zz, img,
                                                feats[r], f)

        # ---- synthesis: kernel levels ----------------------------------
        for r in reversed(self.kernel_res):
            q = self.syn_levels[f"b{r}"]
            w1, w2 = q.conv1, q.conv2
            with tracing.span(self.span_names[r][1]):
                if r == self.kernel_res[-1]:
                    t = sepconv_plain(zz, w1.w_dw, w1.b_dw, w1.w_pw,
                                      final_act=False)
                else:
                    t = fused_block(zz, w1.w_dw, w1.b_dw, w1.w_pw,
                                    final_act=False)
                h, w = feats[r].shape[1:3]
                # static where torch.export traces it: the model's
                # resolution
                n1, n2 = ((q.noise1, q.noise2) if (h, w) == (r, r)
                          else self._noise(r, h, w))
                if r == top:
                    rgb = fused_up_block(t, feats[r], n1, w2.w_dw, w2.b_dw,
                                         w2.w_pw, n2, q.w_rgb, q.b_rgb,
                                         emit_features=False)
                else:
                    zz, rgb = fused_up_block(t, feats[r], n1, w2.w_dw,
                                             w2.b_dw, w2.w_pw, n2, q.w_rgb,
                                             q.b_rgb)
                img = upsample2d(img, f) + rgb
        return img
