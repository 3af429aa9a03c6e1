"""Data parallelism on `torch.distributed`: the port's counterpart of
`migan_tpu/parallel/mesh.py`.

The JAX package runs one program over a global batch sharded on a device
mesh: XLA partitions the gradients' psum, a mean over the global batch is
the all-reduce, and the minibatch-std groups span the global array. Here
each rank is a process with one device and its own rows of the global
batch, so the collectives are explicit:

  - `maybe_initialize_distributed`: the process group, from the env that
    `torch.distributed.run` sets (NCCL on the card, gloo on the CPU);
  - `all_reduce_mean`: a phase's gradients averaged over the ranks in one
    flat all-reduce, as StyleGAN2-ADA's loop does (the port takes its
    gradients with `torch.autograd.grad`, which DDP's reducer does not
    see);
  - `all_gather_rows`: a differentiable all-gather along dim 0 in rank
    order, the global batch of D's minibatch-std;
  - `broadcast_scalar` and `barrier`: rank 0's FID to the others, and
    waiting while rank 0 writes.

Without a process group every helper is the identity (or nothing); with a
group of one rank each still calls its collective, whose result is exact.

A fused training call on a card (`train.train_step.FusedTrainStep`)
captures a step into a CUDA graph, and with it the step's NCCL
collectives (the gradients' all-reduce, the gather and its backward):
NCCL's kernels run on a stream that joins the capture, and the graph
replays them. The communicator must exist before the capture; the
capture's eager warm-up step makes it. gloo is never captured: it serves
the CPU, where the fused call runs its steps eagerly.

Spatial (image-height) sharding, `spatial_sharding` of the JAX package,
is `parallel/spatial.py` on the same process group.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

# Rank 0 runs the in-loop FID while the others wait in a broadcast; the
# timeout must cover one evaluation (an FID50k's statistics and its
# 2048-dim matrix square root on the host take tens of minutes).
TIMEOUT = datetime.timedelta(hours=2)
LAUNCHER_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT")


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world() -> int:
    """Ranks in the process group (1 without one)."""
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if is_initialized() else 0


def backend() -> str:
    return str(dist.get_backend()) if is_initialized() else "none"


def describe(device) -> str:
    """The start line of a run: backend, world size, rank and device."""
    return (f"distributed: backend {backend()}, world {world()}, "
            f"rank {rank()}, device {device}")


def maybe_initialize_distributed(device) -> torch.device:
    """Initialize the process group when the launcher's env is present
    (`WORLD_SIZE`, `RANK`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`, as
    `torch.distributed.run` sets them; a world of 1 counts too) and return
    this rank's device: for a `cuda` device, NCCL on `cuda:LOCAL_RANK`
    (made the current device first); for `cpu`, gloo. Without that env,
    returns `device` and starts nothing. A failed initialization raises:
    there is no fallback to another backend or device."""
    device = torch.device(device)
    env = [k for k in LAUNCHER_ENV if k in os.environ]
    if not env:
        return device
    if len(env) != len(LAUNCHER_ENV):
        raise RuntimeError(f"incomplete launcher env: {env} set, "
                           f"{LAUNCHER_ENV} needed")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {str(device)!r} requested but no "
                               "CUDA device is available")
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
        kw = dict(backend="nccl", device_id=device)
    elif device.type == "cpu":
        kw = dict(backend="gloo")
    else:
        raise ValueError(f"no process group backend for {device}")
    if not is_initialized():
        dist.init_process_group(init_method="env://", timeout=TIMEOUT,
                                world_size=int(os.environ["WORLD_SIZE"]),
                                rank=int(os.environ["RANK"]), **kw)
    return device


def destroy() -> None:
    """Tear the process group down (at a CLI's exit)."""
    if is_initialized():
        dist.destroy_process_group()


def collective_device() -> torch.device:
    """Where the group's tensors live: the current card for NCCL, else the
    CPU."""
    if backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_mean(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The mean over the ranks of each tensor (one all-reduce of their
    concatenation; the tensors share a dtype and the group's device)."""
    tensors = list(tensors)
    if not is_initialized():
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat /= world()
    return [c.view_as(t) for c, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


class _AllGatherRows(torch.autograd.Function):
    """[n, ...] on each rank -> [world * n, ...], the ranks' rows in rank
    order. Its backward is `_SumRows`."""

    @staticmethod
    def forward(ctx, x):
        out = [torch.empty_like(x) for _ in range(world())]
        dist.all_gather(out, x.contiguous())
        return torch.cat(out)

    @staticmethod
    def backward(ctx, grad):
        return _SumRows.apply(grad)


class _SumRows(torch.autograd.Function):
    """The adjoint of the gather: each rank's gradient of the global rows,
    summed over the ranks, and this rank's rows of it. Its backward is the
    gather, so R1's double backward runs through it."""

    @staticmethod
    def forward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        n = grad.shape[0] // world()
        return grad[rank() * n:(rank() + 1) * n].contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _AllGatherRows.apply(grad)


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of `x` in rank order, differentiable to any order
    (every rank must run the same forward and backward); `x` unchanged
    without a group. Each rank passes the same shape."""
    if not is_initialized():
        return x
    return _AllGatherRows.apply(x)


def broadcast_scalar(value: Optional[float]) -> Optional[float]:
    """Rank 0's `value` on every rank (None travels as NaN)."""
    if not is_initialized():
        return value
    t = torch.tensor([float("nan") if value is None else float(value)],
                     dtype=torch.float64, device=collective_device())
    dist.broadcast(t, 0)
    v = t.item()
    return None if v != v else v


def barrier() -> None:
    if is_initialized():
        dist.barrier()
