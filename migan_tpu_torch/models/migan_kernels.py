"""The generator's forward through the hand-written kernels.

Port of `migan_tpu/models/migan_pallas.py:134-303` (`generator_apply_pallas`)
without its TPU layouts: no w-packed rows, no batch folding, no
phase-planar rgb, and no batch-size gate, so the kernels run at every
batch size. Nor does it keep the JAX chain's level cut: there the top
`min(5, log2res - 4)` levels run as kernels and XLA fuses the levels
below, while here every level of the resolution ladder runs through the
kernels, since a plain op is one more host dispatch on the card:

  encoder, each level r > 4   fused_block (conv1), fused_down_block (conv2)
  encoder b4                  fused_block twice (conv1, then conv2 with
                              no down-sampling)
  synthesis b4                fused_block twice (conv1, then conv2 with
                              the skip option); torgb a plain 1x1 conv
  synthesis, each level r > 4 fused_block with final_act=False (conv1's
                              low-res half), then fused_up_block (up-sample
                              + skip + conv2 + torgb; features not stored
                              at the top)

so one forward at resolution 2^k launches 2k sepconv, k - 2
downblock and k - 2 upblock kernels: 18 + 7 + 7 for migan-512, 16 + 6 + 6
for migan-256. The rgb pyramid's step, `img = upsample2d(img) + rgb`,
runs in upblock's torgb epilogue (`img_lo`), so a level's image is one
launch's output; `fromrgb` and the 4x4 level's torgb stay plain 1x1
convs, as they are outside the Pallas kernels in JAX.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

from ..ops.kernels import fused_block, fused_down_block, fused_up_block
from ..utils import tracing
from .migan_inference import (
    ACT, EncoderBlock, Generator, GeneratorConfig, SeparableConv,
    SynthesisBlock, conv1x1_apply, _noise_for,
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

    @property
    def args(self) -> Tuple[torch.Tensor, ...]:
        """(w_dw, b_dw, w_pw), the kernels' weight arguments in order."""
        return self.w_dw, self.b_dw, self.w_pw


class _Level(nn.Module):
    """A level's conv1 and conv2 (`SepWeights`): each encoder level, and
    synthesis b4."""

    def __init__(self, p: EncoderBlock | SynthesisBlock):
        super().__init__()
        self.conv1, self.conv2 = SepWeights(p.conv1), SepWeights(p.conv2)


class _SynthesisLevel(_Level):
    """An up-sampling synthesis level: conv1, conv2, torgb's w_rgb [O, 3]
    and b_rgb [3], and the two scaled noise planes at the level's own
    resolution."""

    def __init__(self, p: SynthesisBlock, noise):
        super().__init__(p)
        self.register_buffer("w_rgb", p.torgb.weight[:, :, 0, 0].t()
                             .contiguous())
        self.register_buffer("b_rgb", p.torgb.bias.clone())
        self.register_buffer("noise1", noise[0])
        self.register_buffer("noise2", noise[1])


def kernel_levels(cfg: GeneratorConfig) -> List[int]:
    """Resolutions of the levels that run a down- and an up-sampling
    kernel, top first: every level above 4. The 4x4 level, which
    resamples nothing, runs as four sepconv launches."""
    return cfg.encode_res[:-1]


def kernel_shapes(cfg: GeneratorConfig) -> List[Tuple]:
    """(kernel, H, W, C, O, final_act) of every launch of one
    `KernelGenerator` forward, in call order: H, W, C the input's size
    (x_lo's for upblock), O the output channels; final_act only for
    sepconv. The fourth 4x4 sepconv takes the skip option."""
    levels = kernel_levels(cfg)
    shapes = []
    for r in levels:
        shapes.append(("sepconv", r, r, cfg.ch(r), cfg.ch(r), True))
        shapes.append(("downblock", r, r, cfg.ch(r), cfg.ch(r // 2), None))
    shapes += [("sepconv", 4, 4, cfg.ch(4), cfg.ch(4), True)] * 4
    for r in reversed(levels):
        h = r // 2
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
    `generator.fromrgb`, then `generator.enc.b<r>` and
    `generator.syn.b<r>` for each level, 4 included.
    """

    def __init__(self, generator: Generator):
        super().__init__()
        cfg = generator.cfg
        self.generator = generator
        self.kernel_res = kernel_levels(cfg)
        self.span_names = {r: (f"generator.enc.b{r}", f"generator.syn.b{r}")
                           for r in cfg.encode_res}
        enc, syn = generator.encoder, generator.synthesis
        with torch.no_grad():
            self.enc_levels = nn.ModuleDict({
                f"b{r}": _Level(enc[f"b{r}"]) for r in cfg.encode_res})
            self.syn_levels = nn.ModuleDict({
                f"b{r}": _SynthesisLevel(syn[f"b{r}"], self._noise(r, r, r))
                for r in self.kernel_res})
            self.syn_levels["b4"] = _Level(syn["b4"])

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
        top = self.kernel_res[0]

        # ---- encoder ---------------------------------------------------
        with tracing.span("generator.fromrgb"):
            z = ACT(conv1x1_apply(g.encoder[f"b{top}"].fromrgb, x))
        feats: Dict[int, torch.Tensor] = {}
        for r in self.kernel_res:
            q = self.enc_levels[f"b{r}"]
            with tracing.span(self.span_names[r][0]):
                feats[r] = fused_block(z, *q.conv1.args)
                z = fused_down_block(feats[r], *q.conv2.args)
        q = self.enc_levels["b4"]
        with tracing.span(self.span_names[4][0]):
            feats[4] = fused_block(z, *q.conv1.args)
            z = fused_block(feats[4], *q.conv2.args)

        # ---- synthesis -------------------------------------------------
        q = self.syn_levels["b4"]
        with tracing.span(self.span_names[4][1]):
            zz = fused_block(z, *q.conv1.args)
            zz = fused_block(zz, *q.conv2.args, skip=feats[4])
            img = conv1x1_apply(g.synthesis["b4"].torgb, zz)
        for r in reversed(self.kernel_res):
            q = self.syn_levels[f"b{r}"]
            w2 = q.conv2.args
            with tracing.span(self.span_names[r][1]):
                t = fused_block(zz, *q.conv1.args, final_act=False)
                h, w = feats[r].shape[1:3]
                # static where torch.export traces it: the model's
                # resolution
                n1, n2 = ((q.noise1, q.noise2) if (h, w) == (r, r)
                          else self._noise(r, h, w))
                # the image of the level below up-sampled and added in the
                # torgb epilogue
                if r == top:
                    img = fused_up_block(t, feats[r], n1, *w2, n2, q.w_rgb,
                                         q.b_rgb, emit_features=False,
                                         img_lo=img)
                else:
                    zz, img = fused_up_block(t, feats[r], n1, *w2, n2,
                                             q.w_rgb, q.b_rgb, img_lo=img)
        return img
