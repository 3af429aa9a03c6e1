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
gradients on the other module.

Under data parallelism each rank holds its rows of the global batch (the
loop lays them out so that rank p's round r of gradient accumulation is
its share of the global round r) and every random draw is the global
batch's (`models.migan.randn`); each phase's gradients are averaged over
the ranks (`parallel.all_reduce_mean`) before they are sanitized and
applied, which is the JAX package's gradient of the global mean.

`make_fused_train_step` (the JAX package's k steps in one program) runs
`steps_per_call` steps per call: on the CPU one `TrainStep` after another,
on a card as replays of CUDA graphs captured from `TrainStep.run`, one
graph for each R1 pattern (`FusedTrainStep`). So that a replay is the
eager step, the step's state on a card is what a graph can replay: Adam
is `capturable` (its step count and bias corrections are device tensors)
and the EMA's beta is a device scalar, in the sequential step too.
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .. import parallel
from ..models import migan
from ..utils.logging import print_log
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
    the square root). On a card it is `capturable`: its step count lives
    on the device and the bias corrections are computed there in float32,
    so that a CUDA graph can replay the update (the default computes them
    on the host in float64, which a graph would freeze)."""
    params = list(params)
    lr, b1, b2, eps = adam_hparams(opt)
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=eps,
                            capturable=any(p.is_cuda for p in params))


def init_adam_state(opt: torch.optim.Adam) -> None:
    """Adam's per-parameter state as its first `step()` makes it (step 0,
    zero moments), for every parameter that has none. A capture must find
    it made: a captured `step()` that made it would zero it at every
    replay."""
    for group in opt.param_groups:
        for p in group["params"]:
            st = opt.state[p]
            if not st:
                st["step"] = torch.zeros(
                    (), dtype=torch.float32,
                    device=p.device if group["capturable"] else "cpu")
                st["exp_avg"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
                st["exp_avg_sq"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)


def load_adam(opt: torch.optim.Adam, sd: Dict) -> None:
    """`opt.load_state_dict(sd)`, keeping `opt`'s own `capturable` (a
    state dict carries its writer's): a checkpoint written on a card
    loads on the CPU and the reverse, the step count moved to where the
    update reads it."""
    capturable = opt.defaults["capturable"]
    opt.load_state_dict(sd)
    for group in opt.param_groups:
        group["capturable"] = capturable
        for p in group["params"]:
            st = opt.state.get(p)
            if st and "step" in st:
                st["step"] = st["step"].to(
                    device=p.device if capturable else "cpu",
                    dtype=torch.float32)


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


def _reduce_and_apply(opt: torch.optim.Optimizer,
                      params: Sequence[nn.Parameter],
                      grads: Sequence[torch.Tensor]) -> None:
    """The ranks' mean gradient, sanitized, applied by `opt`."""
    _apply(opt, params, _sanitize_grads(parallel.all_reduce_mean(grads)))


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
        load_adam(self.opt_G, sd["opt_G"])
        load_adam(self.opt_D, sd["opt_D"])
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


def ema_update(G: nn.Module, G_ema: nn.Module, nimg: int,
               cfg: TrainConfig) -> None:
    """The EMA after `nimg` images (`ema_lerp` with `ema_beta`)."""
    ema_lerp(G, G_ema, ema_beta(nimg, cfg))


@torch.no_grad()
def ema_lerp(G: nn.Module, G_ema: nn.Module, beta) -> None:
    """G_ema <- G + beta (G_ema - G) for every parameter (in place),
    `beta` a float or a 0-d tensor on G's device; buffers (noise_const)
    copied verbatim."""
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
        _reduce_and_apply(state.opt_G, params, grads)
        return stats

    def d_phase(self, state: TrainState, real, mask, generator):
        def loss_fn(x, m, g):
            return losses.d_loss(state.D, state.G, x, m, x * m, g,
                                 compute_dtype=self.cfg.loss.compute_dtype)

        params = list(state.D.parameters())
        grads, stats = _accum_grads(loss_fn, params, (real, mask),
                                    self.rounds, generator)
        _reduce_and_apply(state.opt_D, params, grads)
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
        _reduce_and_apply(state.opt_D, params, grads)
        return stats

    def beta(self, nimg: int, device: torch.device):
        """The EMA's beta after `nimg` images: a float on the CPU, a 0-d
        float32 tensor on a card (where a captured step reads it, so the
        sequential step reads it there too)."""
        beta = ema_beta(nimg, self.cfg)
        if device.type == "cpu":
            return beta
        return torch.full((), beta, dtype=torch.float32, device=device)

    def ema_phase(self, state: TrainState, beta) -> None:
        ema_lerp(state.G, state.G_ema, beta)

    def run(self, state: TrainState, real: torch.Tensor, mask: torch.Tensor,
            generator: torch.Generator, do_dr1: bool, beta
            ) -> Dict[str, torch.Tensor]:
        """The device work of one step on a decoded batch, the EMA with
        `beta` (`self.beta`); `state.step` and `state.nimg` are the
        caller's to advance. What `FusedTrainStep` captures."""
        stats = self.g_phase(state, real, mask, generator)
        stats.update(self.d_phase(state, real, mask, generator))
        if do_dr1:
            stats.update(self.r1_phase(state, real, mask))
        self.ema_phase(state, beta)
        return stats

    def __call__(self, state: TrainState, batch: Dict[str, torch.Tensor],
                 generator: torch.Generator, *, do_dr1: bool = False
                 ) -> Dict[str, torch.Tensor]:
        real, mask = decode_batch(batch["real"], batch["mask"])
        nimg = state.nimg + real.shape[0] * parallel.world()
        stats = self.run(state, real, mask, generator, do_dr1,
                         self.beta(nimg, real.device))
        state.step += 1
        state.nimg = nimg
        return stats


def make_train_step(g_cfg: migan.MiganConfig, d_cfg: migan.MiganConfig,
                    cfg: TrainConfig, teacher=None) -> TrainStep:
    """The step of `TrainStep`, with the teacher in either form of
    `normalize_teacher`."""
    return TrainStep(g_cfg, d_cfg, cfg, normalize_teacher(teacher))


# R1's stats, zero in a fused call's rows where R1 did not run, and the row
# that says where it ran (the JAX package's fused program's names)
R1_KEYS = ("Loss/r1_penalty", "Loss/D/reg")
R1_RAN = "Misc/r1_ran"


def full_stats(stats: Dict[str, torch.Tensor], do_dr1: bool,
                device) -> Dict[str, torch.Tensor]:
    """One step's row of stats: `stats` with R1's keys (zero where R1
    did not run) and R1_RAN, in one order for both R1 patterns, float32
    0-d tensors on `device`."""
    out = {k: v.float() for k, v in stats.items()}
    for k in R1_KEYS:
        if k not in out:
            out[k] = torch.zeros((), device=device)
    out[R1_RAN] = torch.full((), float(do_dr1), device=device)
    return out


@dataclass
class _Captured:
    graph: "torch.cuda.CUDAGraph"
    stats: torch.Tensor          # the step's stats row, [len(keys)]


class FusedTrainStep:
    """`steps_per_call` optimizer steps of a `TrainStep` per call, the
    port of the JAX package's `make_fused_train_step`:
    ``fused(state, batch, seeds) -> stats``, `state` updated in place.

    batch: {"real": [k, N, H, W, 3], "mask": [k, N, H, W, 1]} in either
    wire format; seeds: the k steps' noise seeds (`loop.step_seed` of
    their absolute step indices, as the sequential loop seeds its
    generators). R1 runs where (state.step + i) % d_opt.reg_interval == 0,
    the JAX program's `lax.cond`. stats: {name: [k] float32 tensor} with
    R1's keys in every row (zero where R1 did not run) and R1_RAN (1
    where it ran).

    It runs on `device`, where the batches must lie. On the CPU the k
    steps are `TrainStep` calls one after another (the plain version). On
    a card each step is a replay of a CUDA graph captured from
    `TrainStep.run`, one graph for each R1 pattern (without R1 and, when
    `d_opt.reg_interval` is set, with it), both made at the first call;
    the graphs share one memory pool. A replay reads its batch, the
    EMA's beta and its noise seed from static inputs: the batch and beta
    are copied there on the device, and the generator the graphs were
    captured with (registered with both) is reseeded before each replay,
    which replays the eager stream. Before the captures, one step runs
    eagerly on a copy of the state on a side stream (cuDNN's and cuBLAS's
    plans, the NCCL communicator, the cached filters), with R1 where R1
    is scheduled, so that it runs every op of both patterns, and both
    Adams' state is made (`init_adam_state`). One warm-up for both, and
    both captures after it: the blocks an eager step caches cannot be
    reused by a graph's pool, and a warm-up beside a captured graph's
    pool would double the footprint. A failed capture or replay raises;
    nothing falls back to eager steps. `warm_up_s` and `capture_s` (by
    pattern) hold those times in seconds.
    """

    def __init__(self, step: TrainStep, steps_per_call: int, device):
        if steps_per_call < 1:
            raise ValueError(f"steps_per_call {steps_per_call} < 1")
        self.step, self.k = step, steps_per_call
        self.device = torch.device(device)
        self.interval = step.cfg.d_opt.reg_interval
        self.warm_up_s: Optional[float] = None
        self.capture_s: Dict[bool, float] = {}
        self._graphs: Dict[bool, _Captured] = {}
        self._keys: Optional[List[str]] = None
        self._pool = None
        self._static: Optional[Dict] = None

    def do_dr1(self, step: int) -> bool:
        return bool(self.interval) and step % self.interval == 0

    def __call__(self, state: TrainState, batch: Dict[str, torch.Tensor],
                 seeds: Sequence[int]) -> Dict[str, torch.Tensor]:
        real_k, mask_k = batch["real"], batch["mask"]
        if not (real_k.shape[0] == mask_k.shape[0] == len(seeds) == self.k):
            raise ValueError(f"a call takes {self.k} steps: got batches "
                             f"{real_k.shape[0]}, {mask_k.shape[0]} and "
                             f"{len(seeds)} seeds")
        if real_k.device.type != self.device.type:
            raise ValueError(f"batch on {real_k.device}, the step runs on "
                             f"{self.device}")
        if self.device.type == "cpu":
            rows = []
            for i in range(self.k):
                do = self.do_dr1(state.step)
                stats = self.step(
                    state, {"real": real_k[i], "mask": mask_k[i]},
                    torch.Generator().manual_seed(int(seeds[i])), do_dr1=do)
                rows.append(full_stats(stats, do, "cpu"))
            return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
        return self._replay(state, real_k, mask_k, seeds)

    def _replay(self, state, real_k, mask_k, seeds):
        if not self._graphs:
            self._capture(state, real_k[0], mask_k[0])
        x = self._static
        if real_k.shape[1:] != x["real"].shape or \
                mask_k.shape[1:] != x["mask"].shape:
            raise ValueError(f"batch {tuple(real_k.shape[1:])} is not "
                             f"the captured {tuple(x['real'].shape)}")
        rows = []
        for i in range(self.k):
            x["real"].copy_(real_k[i])
            x["mask"].copy_(mask_k[i])
            nimg = state.nimg + real_k.shape[1] * parallel.world()
            x["beta"].fill_(ema_beta(nimg, self.step.cfg))
            x["gen"].manual_seed(int(seeds[i]))
            captured = self._graphs[self.do_dr1(state.step)]
            captured.graph.replay()
            rows.append(captured.stats.clone())
            state.step += 1
            state.nimg = nimg
        return dict(zip(self._keys, torch.stack(rows, dim=1)))

    def _capture(self, state: TrainState, real: torch.Tensor,
                 mask: torch.Tensor) -> None:
        """The warm-up, then both patterns' captures, from the static
        inputs (set to `real`, `mask`). `torch.cuda.graph` gives the
        warm-up's cached blocks back before it captures."""
        dev = real.device
        self._static = x = {"real": real.clone(), "mask": mask.clone(),
                            "beta": torch.zeros((), device=dev),
                            "gen": torch.Generator(dev)}
        init_adam_state(state.opt_G)
        init_adam_state(state.opt_D)
        patterns = (True, False) if self.interval else (False,)
        t0 = time.perf_counter()
        self._warm_up(state, patterns[0])
        self.warm_up_s = time.perf_counter() - t0
        print_log(f"fused step: one eager warm-up step "
                  f"{'with' if patterns[0] else 'without'} R1 in "
                  f"{self.warm_up_s:.2f} s")
        for do_dr1 in patterns:
            t0 = time.perf_counter()
            graph = torch.cuda.CUDAGraph()
            graph.register_generator_state(x["gen"])
            with torch.cuda.graph(graph, pool=self._pool):
                r, m = decode_batch(x["real"], x["mask"])
                stats = full_stats(
                    self.step.run(state, r, m, x["gen"], do_dr1,
                                  x["beta"]), do_dr1, dev)
                row = torch.stack(list(stats.values()))
            if self._keys is None:
                self._keys = list(stats)
            elif self._keys != list(stats):
                raise RuntimeError(f"R1 pattern {do_dr1}: stats "
                                   f"{list(stats)}, the other pattern's "
                                   f"{self._keys}")
            self._pool = graph.pool()
            self._graphs[do_dr1] = _Captured(graph, row)
            torch.cuda.synchronize(dev)
            self.capture_s[do_dr1] = time.perf_counter() - t0
            print_log(f"fused step: the step "
                      f"{'with' if do_dr1 else 'without'} R1 captured as "
                      f"a CUDA graph in {self.capture_s[do_dr1]:.2f} s")

    def _warm_up(self, state: TrainState, do_dr1: bool) -> None:
        """One step, eagerly, on a copy of `state` on a side stream, from
        the static inputs."""
        dev = self._static["real"].device
        twin = copy.deepcopy(state)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            r, m = decode_batch(self._static["real"], self._static["mask"])
            self.step.run(twin, r, m, torch.Generator(dev).manual_seed(0),
                          do_dr1, self._static["beta"])
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)


def make_fused_train_step(g_cfg: migan.MiganConfig, d_cfg: migan.MiganConfig,
                          cfg: TrainConfig, teacher=None,
                          steps_per_call: int = 8,
                          device="cuda") -> FusedTrainStep:
    """`FusedTrainStep` of `make_train_step(g_cfg, d_cfg, cfg, teacher)` on
    `device`: graph replays on a card, eager steps on the CPU."""
    return FusedTrainStep(make_train_step(g_cfg, d_cfg, cfg, teacher),
                          steps_per_call, device)
