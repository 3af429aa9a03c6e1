"""Parameter summary of a module (port of `migan_tpu/utils/summary.py`;
reference torch_utils/misc.py:192-260 print_module_summary and the
count/sum logged at model construction, lib/model_zoo/common/
get_model.py:86-91), over its `state_dict`: parameters and buffers, as
the JAX package's parameter tree holds both."""

from __future__ import annotations

from typing import Dict, Mapping, Union

import torch
from torch import nn

StateOrModule = Union[nn.Module, Mapping[str, torch.Tensor]]


def _state(tree: StateOrModule) -> Mapping[str, torch.Tensor]:
    return tree.state_dict() if isinstance(tree, nn.Module) else tree


def param_count(tree: StateOrModule) -> int:
    return sum(v.numel() for v in _state(tree).values())


def param_sum(tree: StateOrModule) -> float:
    """Checksum of every value, in float64 (reference get_model.py:89-91
    logs it to fingerprint loaded weights)."""
    return float(sum(v.double().sum() for v in _state(tree).values()))


def print_param_summary(tree: StateOrModule, name: str = "model",
                        max_rows: int = 24, print_fn=print) -> int:
    """Print the element count of each subtree (the first two parts of
    the dotted keys); returns the total."""
    groups: Dict[str, int] = {}
    for key, v in _state(tree).items():
        top = ".".join(key.split(".")[:2])
        groups[top] = groups.get(top, 0) + v.numel()
    total = sum(groups.values())
    width = max([len(k) for k in groups] + [len(name)]) + 2
    print_fn(f"{name:<{width}} {'params':>12}")
    print_fn("-" * (width + 13))
    for k in sorted(groups)[:max_rows]:
        print_fn(f"{k:<{width}} {groups[k]:>12,}")
    if len(groups) > max_rows:
        print_fn(f"... ({len(groups) - max_rows} more subtrees)")
    print_fn("-" * (width + 13))
    print_fn(f"{'total':<{width}} {total:>12,}")
    return total
