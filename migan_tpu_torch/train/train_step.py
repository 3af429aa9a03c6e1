"""The GAN train step, its optimizers and the EMA, on the port's modules.

Port of `migan_tpu/train/train_step.py` (reference lib/experiments/
migan_default.py:177-225,334-358,408-424):

  - the phases of one step, in the reference's order: Gmain, Dmain, Dreg
    (every `d_reg_interval` steps, chosen by the caller) and the EMA
    update, each with its own optimizer step;
  - Adam with the lazy-regularization adjustment, lr *= r / (r + 1) and
    beta **= r / (r + 1) (migan_default.py:344-348);
  - gradients sanitized with nan_to_num(nan=0, +-1e5) (torch_utils/
    misc.py:46-56);
  - the EMA p_ema = p + beta (p_ema - p), beta = 0.5 ** (batch /
    ema_nimg), with the optional ramp-up; buffers (noise_const) copied.

`noise_const` is a buffer of the port's modules, not a parameter, so no
gradient reaches it (the JAX package masks its gradient instead).

Each phase takes the gradient of its loss with respect to its own
module's parameters only (`torch.autograd.grad`), so no phase leaves
gradients on the other module. The JAX package's `make_fused_train_step`
(k steps in one program) has no counterpart: the loop runs the steps one
after another, which its own tests hold equal to the fused program.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..models import migan
from . import loss as losses


@dataclass(frozen=True)
class OptConfig:
    """reference configs/experiment/*.yaml g_opt_kwargs / d_opt_kwargs."""

    lr: float = 1e-3
    beta1: float = 0.0
    beta2: float = 0.99
    eps: float = 1e-8
    reg_interval: Optional[int] = None  # lazy regularization interval


@dataclass(frozen=True)
class TrainConfig:
    g_opt: OptConfig = OptConfig(reg_interval=4)
    d_opt: OptConfig = OptConfig(reg_interval=16)
    loss: losses.LossConfig = losses.LossConfig()
    batch_size: int = 32           # the global batch
    ema_kimg: float = 20.0
    ema_rampup: Optional[float] = None
    # each phase's batch in this many sequential micro-batches, one
    # optimizer step (reference migan_default.py:211-214): the same mean
    # gradient with one micro-batch's activations live at a time
    grad_accum_rounds: int = 1


def adam_hparams(opt: OptConfig) -> Tuple[float, float, float, float]:
    """(lr, beta1, beta2, eps) with the mb_ratio adjustment."""
    lr, b1, b2 = float(opt.lr), float(opt.beta1), float(opt.beta2)
    if opt.reg_interval is not None:
        mb_ratio = opt.reg_interval / (opt.reg_interval + 1)
        lr, b1, b2 = lr * mb_ratio, b1 ** mb_ratio, b2 ** mb_ratio
    return lr, b1, b2, float(opt.eps)


def make_optimizer(params, opt: OptConfig) -> torch.optim.Adam:
    """Adam with the lazy-regularization mb_ratio applied to lr and betas
    (torch's update is optax.adam's: bias-corrected moments, eps outside
    the square root)."""
    lr, b1, b2, eps = adam_hparams(opt)
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=eps)


def _accum_grads(loss_fn: Callable, params: Sequence[torch.Tensor],
                 batch: Tuple[torch.Tensor, ...], rounds: int,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
    """The mean gradient of `loss_fn` with respect to `params` over
    `rounds` micro-batches of `batch` (split along dim 0), and the mean of
    its stats. loss_fn(*chunk[, generator]) -> (loss, stats); the
    micro-batches draw from `generator` one after another."""
    params = list(params)
    rounds = max(1, rounds)
    if batch[0].shape[0] % rounds:
        raise ValueError(f"batch {batch[0].shape[0]} not divisible into "
                         f"{rounds} rounds")
    chunks = zip(*(x.chunk(rounds) for x in batch))
    total: Optional[List[torch.Tensor]] = None
    stats_sum: Dict[str, torch.Tensor] = {}
    for chunk in chunks:
        args = tuple(chunk) + ((generator,) if generator is not None else ())
        loss, stats = loss_fn(*args)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        total = grads if total is None else [
            t + g for t, g in zip(total, grads)]
        for k, v in stats.items():
            stats_sum[k] = stats_sum[k] + v if k in stats_sum else v
    if rounds > 1:
        total = [g / rounds for g in total]
        stats_sum = {k: v / rounds for k, v in stats_sum.items()}
    return total, stats_sum


def _sanitize_grads(grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """reference torch_utils/misc.py:46-56 applied to every gradient."""
    return [torch.nan_to_num(g, nan=0.0, posinf=1e5, neginf=-1e5)
            for g in grads]


def _apply(opt: torch.optim.Optimizer, params: Sequence[nn.Parameter],
           grads: Sequence[torch.Tensor]) -> None:
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
    for p in params:
        p.grad = None


# TrainState fields, in the JAX package's order (its checkpoint layout)
FIELDS = ("params_G", "params_D", "params_G_ema", "opt_G", "opt_D", "step",
          "nimg")


@dataclass
class TrainState:
    """The full training state: both nets, the EMA, both optimizers'
    moments, the step and the images seen. `state_dict()` is what a
    checkpoint holds, under the JAX package's field names."""

    G: migan.Generator
    D: migan.Discriminator
    G_ema: migan.Generator
    opt_G: torch.optim.Adam
    opt_D: torch.optim.Adam
    step: int = 0
    nimg: int = 0

    def state_dict(self) -> Dict:
        return {"params_G": self.G.state_dict(),
                "params_D": self.D.state_dict(),
                "params_G_ema": self.G_ema.state_dict(),
                "opt_G": self.opt_G.state_dict(),
                "opt_D": self.opt_D.state_dict(),
                "step": self.step, "nimg": self.nimg}

    def load_state_dict(self, sd: Dict) -> None:
        self.G.load_state_dict(sd["params_G"])
        self.D.load_state_dict(sd["params_D"])
        self.G_ema.load_state_dict(sd["params_G_ema"])
        self.opt_G.load_state_dict(sd["opt_G"])
        self.opt_D.load_state_dict(sd["opt_D"])
        self.step, self.nimg = int(sd["step"]), int(sd["nimg"])


def init_train_state(generator: torch.Generator, g_cfg: migan.MiganConfig,
                     d_cfg: migan.MiganConfig, cfg: TrainConfig,
                     device="cpu") -> TrainState:
    """G and D with random weights from `generator` (on the CPU, then
    moved to `device`), the EMA a copy of G, fresh optimizers."""
    G = migan.generator_init(g_cfg, generator).to(device)
    D = migan.discriminator_init(d_cfg, generator).to(device)
    return state_from_modules(G, D, cfg)


def state_from_modules(G: migan.Generator, D: migan.Discriminator,
                       cfg: TrainConfig) -> TrainState:
    G_ema = copy.deepcopy(G).eval().requires_grad_(False)
    return TrainState(G=G, D=D, G_ema=G_ema,
                      opt_G=make_optimizer(G.parameters(), cfg.g_opt),
                      opt_D=make_optimizer(D.parameters(), cfg.d_opt))


def ema_beta(nimg: int, cfg: TrainConfig) -> float:
    """0.5 ** (batch / ema_nimg) in float32, as the JAX package computes
    it (reference migan_default.py:413-420)."""
    ema_nimg = np.float32(cfg.ema_kimg * 1000.0)
    if cfg.ema_rampup is not None:
        ema_nimg = min(ema_nimg, np.float32(nimg) * np.float32(
            cfg.ema_rampup))
    return float(np.float32(0.5) ** (np.float32(cfg.batch_size)
                                     / max(ema_nimg, np.float32(1e-8))))


@torch.no_grad()
def ema_update(G: nn.Module, G_ema: nn.Module, nimg: int,
               cfg: TrainConfig) -> None:
    """G_ema <- G + beta (G_ema - G) for every parameter (in place);
    buffers (noise_const) copied verbatim."""
    beta = ema_beta(nimg, cfg)
    for p, e in zip(G.parameters(), G_ema.parameters()):
        e.copy_(p + beta * (e - p))
    for b, e in zip(G.buffers(), G_ema.buffers()):
        e.copy_(b)


def normalize_teacher(teacher) -> Optional[losses.TeacherFn]:
    """The teacher contract: ``(apply_fn, module)`` with
    ``apply_fn(module, x, generator) -> (img, inter)`` (the form the loop
    builds, `models.comodgan.make_teacher_apply`), or a bare
    ``f(x, generator)``; None for no distillation."""
    if teacher is None:
        return None
    if isinstance(teacher, tuple):
        apply_fn, module = teacher
        return lambda x, g: apply_fn(module, x, g)
    return teacher


def decode_batch(real: torch.Tensor, mask: torch.Tensor):
    """The uint8 wire format (train.wire_format 'u8'): images as
    round((x + 1) 127.5), masks 0/1, back to float32; float batches pass
    through."""
    if real.dtype == torch.uint8:
        real = real.float() / 127.5 - 1.0
    if mask.dtype == torch.uint8:
        mask = mask.float()
    return real, mask


@dataclass
class TrainStep:
    """One optimizer step of every phase: ``step(state, batch, generator,
    do_dr1=False) -> stats``, updating `state` in place. batch:
    {"real": [N,H,W,3], "mask": [N,H,W,1]} NHWC, mask 1 = known; every
    random draw of the step comes from `generator`, Gmain's first."""

    g_cfg: migan.MiganConfig
    d_cfg: migan.MiganConfig
    cfg: TrainConfig
    teacher: Optional[losses.TeacherFn] = None
    rounds: int = field(init=False)

    def __post_init__(self):
        self.rounds = max(1, self.cfg.grad_accum_rounds)

    def g_phase(self, state: TrainState, real, mask, generator):
        def loss_fn(x, m, g):
            return losses.g_loss(state.G, state.D, x, m, x * m, g,
                                 self.cfg.loss, self.teacher)

        params = list(state.G.parameters())
        grads, stats = _accum_grads(loss_fn, params, (real, mask),
                                    self.rounds, generator)
        _apply(state.opt_G, params, _sanitize_grads(grads))
        return stats

    def d_phase(self, state: TrainState, real, mask, generator):
        def loss_fn(x, m, g):
            return losses.d_loss(state.D, state.G, x, m, x * m, g,
                                 compute_dtype=self.cfg.loss.compute_dtype)

        params = list(state.D.parameters())
        grads, stats = _accum_grads(loss_fn, params, (real, mask),
                                    self.rounds, generator)
        _apply(state.opt_D, params, _sanitize_grads(grads))
        return stats

    def r1_phase(self, state: TrainState, real, mask):
        gain = self.cfg.d_opt.reg_interval or 1

        def loss_fn(x, m):
            r1, stats = losses.d_r1_loss(
                state.D, x, m, self.cfg.loss.r1_gamma,
                compute_dtype=self.cfg.loss.compute_dtype)
            return r1 * gain, stats

        params = list(state.D.parameters())
        grads, stats = _accum_grads(loss_fn, params, (real, mask),
                                    self.rounds)
        _apply(state.opt_D, params, _sanitize_grads(grads))
        return stats

    def ema_phase(self, state: TrainState, nimg: int) -> None:
        ema_update(state.G, state.G_ema, nimg, self.cfg)

    def __call__(self, state: TrainState, batch: Dict[str, torch.Tensor],
                 generator: torch.Generator, *, do_dr1: bool = False
                 ) -> Dict[str, torch.Tensor]:
        real, mask = decode_batch(batch["real"], batch["mask"])
        stats = self.g_phase(state, real, mask, generator)
        stats.update(self.d_phase(state, real, mask, generator))
        if do_dr1:
            stats.update(self.r1_phase(state, real, mask))
        nimg = state.nimg + real.shape[0]
        self.ema_phase(state, nimg)
        state.step += 1
        state.nimg = nimg
        return stats


def make_train_step(g_cfg: migan.MiganConfig, d_cfg: migan.MiganConfig,
                    cfg: TrainConfig, teacher=None) -> TrainStep:
    """The step of `TrainStep`, with the teacher in either form of
    `normalize_teacher`."""
    return TrainStep(g_cfg, d_cfg, cfg, normalize_teacher(teacher))
