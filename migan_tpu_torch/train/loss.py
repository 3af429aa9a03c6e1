"""MI-GAN training losses on the port's modules.

Port of `migan_tpu/train/loss.py` (reference lib/experiments/loss.py:
24-234):

  - Gmain: the non-saturating loss softplus(-D(composite)) on the
    mask-composited generator output, plus the multi-resolution
    image-level distillation from a Co-Mod-GAN teacher: an L1 on each
    `res_to_rgb` level >= `start_resolution`, masked to the hole by the
    nearest-resized mask;
  - Dmain: softplus(fake logits) + softplus(-real logits);
  - Dr1: the R1 penalty, the gradient of D's summed logits with respect to
    its input taken with `create_graph=True`, so that the backward of the
    loss differentiates through it (the double backward of
    `conv2d_resample`, `upfirdn2d` and `bias_act`).

Everything is NHWC; mask 1 = known, 0 = hole; D's input is
concat([mask - 0.5, image]) (reference loss.py:161-164). Each loss
returns (scalar loss, {name: detached scalar}).

Random draws: the generator's noise, then the teacher's z and noise, all
from the one `torch.Generator` passed in, in that order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..models import migan


@dataclass(frozen=True)
class KDConfig:
    """Image-level knowledge distillation (reference loss.py:171-186;
    configs/experiment/*.yaml image_level_kd_kwargs)."""

    start_resolution: int = 32
    weight: float = 2.0


@dataclass(frozen=True)
class LossConfig:
    r1_gamma: float = 10.0
    kd: Optional[KDConfig] = None
    # Mixed precision: the G/D forward and backward run in this dtype
    # ("bfloat16") while parameters and the optimizer stay float32 (the
    # layers cast their weights to the activations' dtype), so casting the
    # loss inputs is the whole policy; the loss on the logits is float32.
    # None: float32.
    compute_dtype: Optional[str] = None


def _cast(dtype_name: Optional[str], *xs):
    """The inputs in the compute dtype (LossConfig.compute_dtype)."""
    if dtype_name is None:
        return xs
    return tuple(x.to(getattr(torch, dtype_name)) for x in xs)


# teacher(x, generator) -> (img, {"res_to_rgb": {res: tensor}, ...})
TeacherFn = Callable[[torch.Tensor, torch.Generator],
                     Tuple[torch.Tensor, Dict]]


def nearest_resize_mask(mask: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The JAX package's nearest resize of an NHWC mask
    (`jax.image.resize(..., "nearest")`, half-pixel centers: torch's
    'nearest-exact'). The reference's F.interpolate(mode='nearest') takes
    the other pixel of each pair when it halves (ROADMAP, open questions
    about the JAX package)."""
    return F.interpolate(mask.permute(0, 3, 1, 2), size=(h, w),
                         mode="nearest-exact").permute(0, 2, 3, 1)


def g_loss(G: migan.Generator, D: migan.Discriminator, real: torch.Tensor,
           mask: torch.Tensor, erased: torch.Tensor,
           generator: torch.Generator, loss_cfg: LossConfig,
           teacher: Optional[TeacherFn] = None
           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Gmain (reference loss.py:159-190)."""
    real, mask, erased = _cast(loss_cfg.compute_dtype, real, mask, erased)
    gen_x = torch.cat([mask - 0.5, erased], dim=-1)
    gen_img, inter = migan.generator_apply(
        G, gen_x, noise_mode="random", generator=generator,
        return_intermediate=True)
    combined = gen_img * (1 - mask) + real * mask
    gen_logits = migan.discriminator_apply(
        D, torch.cat([mask - 0.5, combined], dim=-1)).float()
    loss = F.softplus(-gen_logits).mean()
    stats = {"Loss/scores/fake": gen_logits.mean(),
             "Loss/signs/fake": gen_logits.sign().mean()}
    if teacher is not None and loss_cfg.kd is not None:
        _, t_inter = teacher(gen_x, generator)
        kd_loss = 0.0
        for res, t_rgb in t_inter["res_to_rgb"].items():
            if res < loss_cfg.kd.start_resolution:
                continue
            g_rgb = inter["res_to_rgb"][res]
            m = nearest_resize_mask(mask, g_rgb.shape[1], g_rgb.shape[2])
            kd_loss = kd_loss + ((g_rgb - t_rgb.detach()).abs()
                                 * (1 - m)).mean()
        loss = loss + loss_cfg.kd.weight * kd_loss
        stats["Loss/G/kd_l1_image_level_loss"] = kd_loss
    stats["Loss/G/loss"] = loss
    return loss, {k: torch.as_tensor(v).detach() for k, v in stats.items()}


def d_loss(D: migan.Discriminator, G: migan.Generator, real: torch.Tensor,
           mask: torch.Tensor, erased: torch.Tensor,
           generator: torch.Generator,
           compute_dtype: Optional[str] = None
           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Dmain: fake and real terms (reference loss.py:192-221); no
    gradient reaches G."""
    real, mask, erased = _cast(compute_dtype, real, mask, erased)
    gen_x = torch.cat([mask - 0.5, erased], dim=-1)
    with torch.no_grad():
        gen_img = migan.generator_apply(G, gen_x, noise_mode="random",
                                        generator=generator)
    combined = gen_img * (1 - mask) + real * mask
    fake_logits = migan.discriminator_apply(
        D, torch.cat([mask - 0.5, combined], dim=-1)).float()
    loss_fake = F.softplus(fake_logits).mean()
    real_logits = migan.discriminator_apply(
        D, torch.cat([mask - 0.5, real], dim=-1)).float()
    loss_real = F.softplus(-real_logits).mean()
    stats = {"Loss/scores/fake": fake_logits.mean(),
             "Loss/signs/fake": fake_logits.sign().mean(),
             "Loss/scores/real": real_logits.mean(),
             "Loss/signs/real": real_logits.sign().mean(),
             "Loss/D/loss": loss_fake + loss_real}
    return loss_fake + loss_real, {k: v.detach() for k, v in stats.items()}


def d_r1_loss(D: migan.Discriminator, real: torch.Tensor,
              mask: torch.Tensor, r1_gamma: float,
              compute_dtype: Optional[str] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Dr1 (reference loss.py:223-231): the gradient is taken with respect
    to D's input with `create_graph=True`; backpropagating the result to
    D's parameters is a double backward."""
    real, mask = _cast(compute_dtype, real, mask)
    real_x = torch.cat([mask - 0.5, real], dim=-1).detach().requires_grad_()
    logits = migan.discriminator_apply(D, real_x).float()
    (r1_grads,) = torch.autograd.grad(logits.sum(), real_x,
                                      create_graph=True)
    r1_penalty = r1_grads.float().square().sum(dim=(1, 2, 3))
    loss = r1_penalty.mean() * (r1_gamma / 2.0)
    return loss, {"Loss/r1_penalty": r1_penalty.mean().detach(),
                  "Loss/D/reg": loss.detach()}
