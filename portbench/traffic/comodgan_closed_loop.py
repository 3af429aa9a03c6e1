"""Closed loop, one caller, through Co-Mod-GAN: batches of model inputs
from the host through `load_model`'s forward and back to the host with
`.cpu()`, the next call as soon as the last has returned
(`closed_loop.measure`).

The model runs in `load_model`'s reproducible mode: one latent drawn
from the seed (`z.npy` beside the weights, `--z-npy`), broadcast over the
batch, and the checkpoint's constant noise (`noise_mode="const"`). Its
default, a random z and random noise per call, cannot be compared with a
reference.

Mix parameters and end-to-end candidates: those of `closed_loop`.
"""

from __future__ import annotations

import sys
import threading
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from .. import check, program
from ..reference import comodgan as ref
from . import images
from .closed_loop import State as _State
from .closed_loop import Window, measure, release  # noqa: F401  (the kind)


@dataclass
class State(_State):
    z: Path = None               # the run's latent [1, z_dim], .npy


def write_weights(run):
    """The seeded checkpoint (`.pt` state_dict) and latent (`.npy`) in the
    run's scratch directory."""
    cfg = run.config
    state = ref.seeded_state(cfg, run.seed, run.device)
    path = run.scratch() / "weights.pt"
    torch.save({k: v.cpu() for k, v in state.items()}, path)
    z = images.rng(run.seed, 8).standard_normal((1, cfg["z_dim"]))
    z_path = run.scratch() / "z.npy"
    np.save(z_path, z.astype(np.float32))
    return path, z_path


def load(run, path: Path, z_path: Path):
    """`load_model`'s forward in its reproducible mode: [N, R, R, 4] host
    float32 -> float32 [N, R, R, 3] on the device."""
    from migan_tpu_torch.cli.demo import load_model

    cfg = run.config
    forward, res = load_model(cfg["model_name"], str(path), cfg["dtype"],
                              run.device, ch_base=cfg["ch_base"],
                              ch_max=cfg["ch_max"], z_npy=str(z_path),
                              noise_mode="const")
    if res != cfg["resolution"]:
        raise RuntimeError(f"load_model gave resolution {res}, the "
                           f"configuration {cfg['resolution']}")
    return run.wrap(forward) if run.wrap else forward


def setup(run) -> State:
    mix, res = run.mix, run.config["resolution"]
    pool = {}
    maker = threading.Thread(target=lambda: pool.setdefault(
        "x", images.closed_pool(run.seed, mix["pool"], res, *mix["hole"])))
    maker.start()
    t0 = time.perf_counter()
    path, z_path = write_weights(run)
    forward = load(run, path, z_path)
    t1 = time.perf_counter()
    maker.join()
    t2 = time.perf_counter()
    batches = pool["x"].reshape(-1, mix["batch"], res, res, 4)
    order = images.rng(run.seed, 4).permutation(len(batches))
    for i in range(mix["warmup_calls"]):
        forward(batches[order[i % len(order)]]).cpu()
    if run.device == "cuda":
        torch.cuda.synchronize()
    print(f"setup: weights and load_model {t1 - t0:.3f} s, then the pool "
          f"{t2 - t1:.3f} s more, warm-up {time.perf_counter() - t2:.3f} s",
          file=sys.stderr)
    return State(forward, batches, order, path, z_path)


def reference_outputs(run, st: State, batches, tf32: bool = False,
                      block: int = 4) -> dict:
    """{b: the reference's outputs [batch, R, R, 3] for st.batches[b]} as
    host float32 arrays, computed `block` images at a time on the
    checkpoint and latent that the program read. tf32=True is the
    control of lower precision."""
    state = program.read_weights(run, st.weights)
    z = torch.as_tensor(np.load(st.z)).to(run.device)
    out = {}
    for b in batches:
        xs = st.batches[b]
        out[b] = np.concatenate([
            ref.forward(run.config, state,
                        torch.as_tensor(xs[i:i + block]).to(run.device), z,
                        tf32=tf32).cpu().numpy()
            for i in range(0, len(xs), block)])
    return out


def check_outputs(run, st: State, outputs) -> dict:
    """outputs: (batch index, [batch, R, R, 3] host tensor) pairs, held
    image by image against the reference on the same inputs."""
    refs = reference_outputs(run, st, sorted({b for b, _ in outputs}))
    pairs = []
    for b, y in outputs:
        y = np.asarray(y)
        if len(y) != len(refs[b]):       # rows missing: a misshapen answer
            return check.image_numbers([(y, refs[b])])
        pairs += zip(y, refs[b])
    return check.image_numbers(pairs)


def verify(run, st: State, win: Window) -> dict:
    return check_outputs(run, st, win.sample)


def control(run, st: State, win: Window) -> dict:
    """The reference in TF32 put in the program's place on the window's
    sampled inputs: the readings that the limits must fail."""
    outs = reference_outputs(run, st, sorted({b for b, _ in win.sample}),
                             tf32=True)
    return check_outputs(run, st, [(b, outs[b]) for b, _ in win.sample])
