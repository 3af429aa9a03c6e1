"""Serialize the port's programs with `torch.export` (`.pt2`): the port's
counterpart of `migan_tpu/export/stablehlo.py`.

`export_fn` traces a module at example arguments into an
`ExportedProgram`; its weights become the program's parameters and
buffers. The kernels are the custom ops
`migan::fused_block`, `migan::fused_down_block` and
`migan::fused_up_block` (`ops/kernels/`), so the program keeps the kernel
chain: on a card it launches the same kernels as the live module.

Dynamic sizes are `torch.export.Dim`s (the counterpart of jax.export's
symbolic shapes and constraints): `dynamic_shapes` maps each argument to
{dim index: Dim}, e.g. {1: Dim("h", min=8), 2: Dim("w", min=8)}.

Loading: `torch.export.load` must find the custom ops registered, which
importing `migan_tpu_torch.ops.kernels` does (`load` below imports it);
a program that holds the kernel ops cannot be loaded in a process that
has not imported the port package.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn

from ..ops import kernels as _kernels  # noqa: F401  (registers the ops)


def export_fn(module: nn.Module, example_args: Sequence[torch.Tensor],
              dynamic_shapes: Optional[Sequence[Optional[dict]]] = None
              ) -> torch.export.ExportedProgram:
    """`torch.export.export` of the module at the example arguments'
    shapes (or the given dynamic ones)."""
    return torch.export.export(
        module, tuple(example_args),
        dynamic_shapes=None if dynamic_shapes is None
        else tuple(dynamic_shapes))


def load_fn(program: torch.export.ExportedProgram) -> Callable:
    """A callable of an exported program."""
    return program.module()


def save(path: str, module: nn.Module, example_args,
         dynamic_shapes=None) -> torch.export.ExportedProgram:
    """Export the module (see :func:`export_fn`) and write the program to
    `path`; returns the program."""
    program = export_fn(module, example_args, dynamic_shapes)
    torch.export.save(program, path)
    return program


def load(path: str) -> Callable:
    """The callable of a `.pt2` written by :func:`save` (the kernel ops
    are registered by this module's import)."""
    return load_fn(torch.export.load(path))
