"""Free-form masks to PNG files (port of `migan_tpu/cli/generate_masks.py`;
reference scripts/generate_masks.py): the PIL generator
(`data/masks.py`) from the global numpy and `random` streams seeded with
--seed, one mask per image under --img-dir (named by the image's stem,
in sorted order) or --count masks named 000000.png, ... . With the same
arguments it writes the JAX CLI's PNGs, pixel for pixel; 255 = known,
0 = hole. Host only: no device is used.

    python -m migan_tpu_torch.cli.generate_masks --out-dir masks/ \
        [--img-dir imgs/] [--count 100] [--resolution 256] [--seed 0]
"""

from __future__ import annotations

import argparse
import os
import random
from glob import glob
from pathlib import Path

import numpy as np


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out-dir", type=Path, required=True)
    p.add_argument("--img-dir", type=Path, default=None,
                   help="name masks after these images' stems")
    p.add_argument("--count", type=int, default=100)
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--hole-range", type=float, nargs=2, default=[0.0, 1.0])
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def main(argv=None) -> list:
    """Runs the CLI; returns the paths written."""
    args = get_args(argv)
    from PIL import Image

    from ..data.masks import random_mask_uint8

    np.random.seed(args.seed)
    random.seed(args.seed)
    args.out_dir.mkdir(parents=True, exist_ok=True)
    if args.img_dir is not None:
        stems = sorted(Path(p).stem for ext in (".jpg", ".jpeg", ".png")
                       for p in glob(os.path.join(str(args.img_dir), "**",
                                                  f"*{ext}"),
                                     recursive=True))
    else:
        stems = [f"{i:06d}" for i in range(args.count)]
    written = []
    for stem in stems:
        mask = random_mask_uint8(args.resolution,
                                 hole_range=tuple(args.hole_range))
        path = args.out_dir / f"{stem}.png"
        Image.fromarray(mask).convert("L").save(path)
        written.append(path)
    print(f"wrote {len(stems)} masks to {args.out_dir}")
    return written


if __name__ == "__main__":
    main()
