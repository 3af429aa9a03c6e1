"""The system under test, reached through its entry point
(`migan_tpu_torch.cli.demo.load_model`), and the weights both it and the
reference read: a checkpoint drawn from the seed on the device in three
calls (`reference.generator.seeded_state`) and written as a `.pt`
state_dict, the published checkpoint format, under the run's scratch
directory."""

from __future__ import annotations

from pathlib import Path

import torch

from .reference import generator as ref


def write_weights(run) -> Path:
    state = ref.seeded_state(run.config, run.seed, run.device)
    path = run.scratch() / "weights.pt"
    torch.save({k: v.cpu() for k, v in state.items()}, path)
    return path


def read_weights(run, path: Path) -> dict:
    """The checkpoint as the reference takes it, on the run's device."""
    return torch.load(path, map_location=run.device, weights_only=True)


def load(run, path: Path):
    """`load_model`'s forward: [N, R, R, 4] host float32 -> float32
    [N, R, R, 3] on the device."""
    from migan_tpu_torch.cli.demo import load_model

    forward, res = load_model(run.config["model_name"], str(path),
                              run.config["dtype"], run.device)
    if res != run.config["resolution"]:
        raise RuntimeError(f"load_model gave resolution {res}, the "
                           f"configuration {run.config['resolution']}")
    return run.wrap(forward) if run.wrap else forward


def reference_outputs(run, state: dict, xs, tf32: bool = False,
                      block: int = 4):
    """The reference's outputs for host inputs xs [N, R, R, 4], computed
    `block` images at a time, as host float32 arrays. tf32=True is the
    control of lower precision."""
    out = []
    for i in range(0, len(xs), block):
        x = torch.as_tensor(xs[i:i + block]).to(run.device)
        out.extend(ref.forward(run.config, state, x, tf32=tf32).cpu()
                   .numpy())
    return out


def free() -> None:
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
