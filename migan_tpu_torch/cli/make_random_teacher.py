"""Write a seeded random Co-Mod-GAN teacher as a training `.npz` (port of
`scripts/make_random_teacher.py`).

    python -m migan_tpu_torch.cli.make_random_teacher --resolution 128 \
        [--seed 7] [--out data/teachers/comodgan_rand_128.npz]

The distillation configs (`configs/experiment/demo_places128_kd.yaml`)
need the Co-Mod-GAN teacher's forward in every Gmain, and the published
teacher is not in the repo: a random teacher at full width has its
compute, memory and program shape (the student learns nothing useful
from it). The file is in the JAX package's params layout
(`io/train_weights.py`), so both packages and `train.image_level_kd_kwargs.
teacher1_path` read it.

The weights are `models.comodgan.generator_init` from a torch generator
seeded with --seed: the same initial statistics as the JAX script's, but
another random stream, so the two scripts write different weights for
one seed. Host only: no device is used.
"""

from __future__ import annotations

import argparse
import os

import torch


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--resolution", type=int, default=128)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--out", type=str,
                   default="data/teachers/comodgan_rand_128.npz")
    return p.parse_args(argv)


def main(argv=None) -> str:
    """Runs the CLI; returns the path written."""
    args = get_args(argv)
    from ..io.train_weights import save_train_npz
    from ..models.comodgan import CoModGANConfig, generator_init

    teacher = generator_init(CoModGANConfig(resolution=args.resolution),
                             torch.Generator().manual_seed(args.seed))
    n = sum(p.numel() for p in teacher.parameters())
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    save_train_npz(args.out, teacher)
    print(f"wrote {args.out}: CoModGAN G resolution={args.resolution} "
          f"params={n:,}")
    return args.out


if __name__ == "__main__":
    main()
