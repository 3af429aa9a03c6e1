"""Checkpoint and resume of the full training state.

Port of `migan_tpu/train/checkpoint.py`. A checkpoint is the directory
`<dir>/step_<8 digits>` holding `state.pt`: `torch.save` of
`TrainState.state_dict()` (both nets, the EMA, both Adam states with their
moments, step, nimg; the reference's pkls drop the optimizer state). It
is written under a temporary name in the same directory and renamed when
complete, so a run killed mid-save leaves a torn temporary directory that
`latest` skips, never a partial `step_*`.

A checkpoint directory of the JAX package (orbax) cannot be read without
JAX; `restore` and `extract_field` refuse it and say so.
"""

from __future__ import annotations

import os
import re
import shutil
import tempfile
from typing import Any, Dict, Optional

import torch

from .train_step import FIELDS, TrainState

STATE_FILE = "state.pt"


def _state_file(path: str) -> str:
    f = os.path.join(path, STATE_FILE)
    if os.path.isfile(f):
        return f
    if os.path.isdir(path) and os.listdir(path):
        raise ValueError(
            f"{path} holds no {STATE_FILE}: a checkpoint directory of the "
            "JAX package (orbax) cannot be read without JAX. Extract its "
            "weights to a .npz with migan_tpu's tools, or resume from a "
            "checkpoint of the port.")
    raise FileNotFoundError(f"no checkpoint at {path}")


def save(ckpt_dir: str, step: int, state: TrainState) -> str:
    """Write `state` as `<ckpt_dir>/step_<step>`; returns its path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(ckpt_dir, f"step_{step:08d}"))
    tmp = tempfile.mkdtemp(prefix=f"step_{step:08d}.tmp-", dir=ckpt_dir)
    try:
        torch.save(state.state_dict(), os.path.join(tmp, STATE_FILE))
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return path


def load(path: str, map_location="cpu") -> Dict[str, Any]:
    """The checkpoint's state dict (tensors on `map_location`)."""
    return torch.load(_state_file(path), map_location=map_location,
                      weights_only=True)


def restore(path: str, state: TrainState) -> TrainState:
    """Load the checkpoint at `path` into `state` (its modules keep their
    device) and return it."""
    device = next(state.G.parameters()).device
    state.load_state_dict(load(path, map_location=device))
    return state


def extract_field(path: str, field: str = "params_G_ema"):
    """One field of a checkpoint (for the demo and export CLIs: the EMA
    weights as a state_dict), without building a model."""
    if field not in FIELDS:
        raise ValueError(f"unknown TrainState field {field!r}; have "
                         f"{list(FIELDS)}")
    return load(path)[field]


def latest(ckpt_dir: str) -> Optional[str]:
    """The newest committed checkpoint of `ckpt_dir`: only exact
    `step_<n>` names count, so a temporary directory torn by a crash
    mid-save is skipped."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [d for d in os.listdir(ckpt_dir)
             if re.fullmatch(r"step_\d+", d)]
    if not steps:
        return None
    return os.path.join(ckpt_dir, sorted(steps)[-1])
