"""The model's activation, `lrelu_agc` (port of `migan_tpu/ops/bias_act.py`
:90-112; reference lib/model_zoo/common/utils.py:96-125)."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

_SQRT2 = math.sqrt(2.0)


@dataclass(frozen=True)
class lrelu_agc:
    """Leaky ReLU with gain and clamp:
    ``y = clip(lrelu(x, alpha) * gain, ±clamp)``; gain may be "sqrt_2"."""

    alpha: float = 0.1
    gain: float | str = 1.0
    clamp: Optional[float] = None

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        g = _SQRT2 if self.gain == "sqrt_2" else float(self.gain)
        x = torch.where(x >= 0, x, x * self.alpha)
        if g != 1.0:
            x = x * g
        if self.clamp is not None:
            x = x.clamp(-float(self.clamp), float(self.clamp))
        return x
