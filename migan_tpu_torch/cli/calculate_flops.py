"""FLOPs per image of the model zoo (port of
`migan_tpu/cli/calculate_flops.py`; reference scripts/calculate_flops.py,
fvcore).

    python -m migan_tpu_torch.cli.calculate_flops [--models migan-256 \
        migan-512 comodgan-256 comodgan-512] [--batch 1]

Counted by `torch.utils.flop_counter.FlopCounterMode` over the plain
generators (`models.migan_inference`, `models.comodgan`) on the meta
device: the FLOPs of the model, not of the kernel chain (the `migan::*`
ops have no FLOP formula). The counter counts convolutions and matrix
products; the JAX CLI reads XLA's cost analysis, which also counts the
elementwise ops: 22.16 and 30.93 GFLOPs/image at migan-256 and -512
against this CLI's 21.79 and 30.15 (1.7% and 2.5% more), 257.15 against
259.18 at comodgan-256.
"""

from __future__ import annotations

import argparse

import torch
from torch.utils.flop_counter import FlopCounterMode


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--models", nargs="+",
                   default=["migan-256", "migan-512", "comodgan-256",
                            "comodgan-512"])
    p.add_argument("--batch", type=int, default=1)
    return p.parse_args(argv)


def flops_of(fn, *example_args) -> int:
    """FLOPs of one call of fn(*example_args), as FlopCounterMode counts
    them."""
    with FlopCounterMode(display=False) as counter:
        fn(*example_args)
    return counter.get_total_flops()


def model_flops(name: str, batch: int = 1) -> int:
    """FLOPs of one forward of `name` (migan-<res> or comodgan-<res>) at
    `batch`."""
    family, res = name.rsplit("-", 1)
    res = int(res)
    with torch.device("meta"):
        x = torch.zeros(batch, res, res, 4)
        if family == "migan":
            from ..models import migan_inference as mi

            g = mi.Generator(mi.GeneratorConfig(resolution=res))
            return flops_of(mi.generator_apply, g, x)
        if family == "comodgan":
            from ..models import comodgan

            g = comodgan.CoModGANGenerator(
                comodgan.CoModGANConfig(resolution=res))
            z = torch.zeros(batch, g.cfg.z_dim)
            return flops_of(lambda: comodgan.generator_apply(
                g, x, z=z, noise_mode="const"))
    raise ValueError(name)


def main(argv=None):
    args = get_args(argv)
    out = {}
    for name in args.models:
        out[name] = model_flops(name, args.batch)
        print(f"{name}: {out[name] / 1e9 / args.batch:.2f} GFLOPs/image "
              f"(FlopCounterMode, batch {args.batch})")
    return out


if __name__ == "__main__":
    main()
