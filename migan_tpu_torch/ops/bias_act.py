"""Bias + activation + gain + clamp (port of `migan_tpu/ops/bias_act.py`;
reference torch_utils/ops/bias_act.py:23-33 and the `lrelu_agc` unit of
lib/model_zoo/common/utils.py:62-125).

`bias_act` with the reference's nine activations, the model's activation
`lrelu_agc` (callable with a runtime gain that also scales its clamp),
and `get_unit`, the parser of the activation strings of the model
configs."""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F

_SQRT2 = math.sqrt(2.0)


@dataclass(frozen=True)
class ActivationSpec:
    fn: Callable[[torch.Tensor, float], torch.Tensor]  # (x, alpha) -> y
    def_alpha: float = 0.0
    def_gain: float = 1.0


# The reference's registry (bias_act.py:23-33), 9 activations.
activation_funcs = {
    "linear": ActivationSpec(lambda x, a: x, 0.0, 1.0),
    "relu": ActivationSpec(lambda x, a: torch.clamp(x, min=0.0), 0.0, _SQRT2),
    "lrelu": ActivationSpec(lambda x, a: torch.where(x >= 0, x, x * a), 0.2,
                            _SQRT2),
    "tanh": ActivationSpec(lambda x, a: torch.tanh(x), 0.0, 1.0),
    "sigmoid": ActivationSpec(lambda x, a: torch.sigmoid(x), 0.0, 1.0),
    "elu": ActivationSpec(lambda x, a: F.elu(x), 0.0, 1.0),
    "selu": ActivationSpec(lambda x, a: F.selu(x), 0.0, 1.0),
    "softplus": ActivationSpec(lambda x, a: F.softplus(x), 0.0, 1.0),
    "swish": ActivationSpec(lambda x, a: F.silu(x), 0.0, _SQRT2),
}


def bias_act(x: torch.Tensor, b: Optional[torch.Tensor] = None,
             dim: int = -1, act: str = "linear",
             alpha: Optional[float] = None, gain: Optional[float] = None,
             clamp: Optional[float] = None) -> torch.Tensor:
    """``clamp(gain * act(x + b), -clamp, clamp)``.

    b: optional [C] bias along `dim` (default the last, channels of NHWC);
    alpha and gain default to the activation's own; clamp applies when
    not None and >= 0.
    """
    spec = activation_funcs[act]
    alpha = float(spec.def_alpha if alpha is None else alpha)
    gain = float(spec.def_gain if gain is None else gain)
    clamp = float(clamp) if clamp is not None else -1.0
    if b is not None:
        if b.ndim != 1:
            raise ValueError(f"bias_act: bias of shape {tuple(b.shape)}")
        shape = [1] * x.ndim
        shape[dim] = b.shape[0]
        x = x + b.reshape(shape).to(x.dtype)
    x = spec.fn(x, alpha)
    if gain != 1.0:
        x = x * gain
    if clamp >= 0.0:
        x = x.clamp(-clamp, clamp)
    return x


@dataclass(frozen=True)
class lrelu_agc:
    """Leaky ReLU with gain and clamp:
    ``y = clip(lrelu(x, alpha) * (self.gain * gain), ±(clamp * gain))``;
    self.gain may be "sqrt_2". The runtime `gain` is how the
    discriminator's residual branches apply their sqrt(0.5)."""

    alpha: float = 0.1
    gain: float | str = 1.0
    clamp: Optional[float] = None

    def __call__(self, x: torch.Tensor, gain: float = 1.0) -> torch.Tensor:
        g = (_SQRT2 if self.gain == "sqrt_2" else float(self.gain)) * gain
        x = torch.where(x >= 0, x, x * self.alpha)
        if g != 1.0:
            x = x * g
        if self.clamp is not None:
            c = float(self.clamp) * gain
            x = x.clamp(-c, c)
        return x


_UNITS = {"lrelu_agc": lrelu_agc, "none": None}


def _str2value(v: str):
    v = v.strip()
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    if v in ("True", "true"):
        return True
    if v in ("False", "false"):
        return False
    return v


def get_unit(spec: Optional[str]):
    """An activation config string, e.g.
    ``'lrelu_agc(alpha=0.2, gain=sqrt_2, clamp=256)'``, as a callable
    (None for None or 'none')."""
    if spec is None:
        return None
    m = re.match(r"^\s*([\w]+)\s*(?:\((.*)\))?\s*$", spec)
    if m is None:
        raise ValueError(f"bad unit spec: {spec!r}")
    name, argstr = m.group(1), m.group(2)
    if name not in _UNITS:
        raise ValueError(f"unknown unit {name!r} in {spec!r}")
    cls = _UNITS[name]
    if cls is None:
        return None
    kwargs = {}
    if argstr:
        for part in argstr.split(","):
            k, _, v = part.partition("=")
            kwargs[k.strip()] = _str2value(v)
    return cls(**kwargs)
