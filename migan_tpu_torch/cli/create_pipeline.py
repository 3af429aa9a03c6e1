"""Build and export the inpainting app pipeline on the port, and check it
(port of `migan_tpu/cli/create_pipeline.py`; reference
scripts/create_onnx_pipeline.py):

    python -m migan_tpu_torch.cli.create_pipeline --resolution 512 \
        --model-path migan_512.npz --images-dir imgs/ --masks-dir masks/ \
        --output-dir out/ --device cuda [--polymorphic]

The pipeline (mask-box crop -> resize -> generator through the kernel
chain -> feathered composite, `export/pipeline.py`) is exported with
`torch.export` as one `.pt2` per size bucket (--buckets), and with
--polymorphic also as one program of dynamic H, W >= 8 (the bound the
reflect-padded blur needs). The generator's input is always [1, res, res,
4], so the kernel chain inside stays static. I/O: uint8 RGB image [1, H,
W, 3] and uint8 mask [1, H, W, 1], 255 = known. The self-check pads each
image to the smallest bucket that holds it, runs the bucket's exported
program, crops, and writes sample_results/. Load a `.pt2` after importing
`migan_tpu_torch.ops.kernels`, which registers the kernel ops.
"""

from __future__ import annotations

import argparse
import os
from glob import glob
from pathlib import Path

import numpy as np
import torch

# the lower bound of a dynamic side: the reflect pad of the 5x5 blur
MIN_SIDE = 8


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--resolution", type=int, required=True)
    p.add_argument("--model-path", type=str, required=True)
    p.add_argument("--images-dir", type=Path, required=True)
    p.add_argument("--masks-dir", type=Path, required=True)
    p.add_argument("--invert-mask", action="store_true")
    p.add_argument("--output-dir", type=Path, required=True)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' raises when no card is "
                   "present.")
    p.add_argument("--buckets", type=str, default="512,1024")
    p.add_argument("--polymorphic", action="store_true",
                   help="also export ONE program of dynamic H, W (the "
                   "reference ONNX dynamic axes' counterpart) beside the "
                   "buckets")
    return p.parse_args(argv)


def _example(b: int, device):
    return (torch.zeros(1, b, b, 3, dtype=torch.uint8, device=device),
            torch.full((1, b, b, 1), 255, dtype=torch.uint8, device=device))


def main(argv=None) -> dict:
    """Runs the CLI; returns {program name: `.pt2` path}."""
    args = get_args(argv)
    from PIL import Image
    from torch.export import Dim

    from ..data.preprocess import read_mask
    from ..export import torch_export
    from ..export.pipeline import make_pipeline
    from .demo import load_model

    (args.output_dir / "models").mkdir(parents=True, exist_ok=True)
    (args.output_dir / "sample_results").mkdir(parents=True, exist_ok=True)

    forward, resolution = load_model(f"migan-{args.resolution}",
                                     args.model_path, device=args.device)
    pipeline = make_pipeline(forward, resolution, device=args.device)

    buckets = sorted(int(b) for b in args.buckets.split(","))
    programs, written = {}, {}
    print("Exporting the pipeline buckets (torch.export)...")
    for b in buckets:
        path = args.output_dir / "models" / f"migan_pipeline_{b}.pt2"
        programs[b] = torch_export.save(str(path), pipeline,
                                        _example(b, args.device))
        written[str(b)] = str(path)
        print(f"  exported {path}")
    if args.polymorphic:
        # one program, dynamic H and W (the reference's ONNX dynamic axes,
        # create_onnx_pipeline.py:293-318)
        h, w = Dim("h", min=MIN_SIDE), Dim("w", min=MIN_SIDE)
        path = args.output_dir / "models" / "migan_pipeline_dynamic.pt2"
        torch_export.save(str(path), pipeline, _example(buckets[0],
                                                        args.device),
                          [{1: h, 2: w}, {1: h, 2: w}])
        written["dynamic"] = str(path)
        print(f"  exported {path} (dynamic H, W >= {MIN_SIDE})")

    run = {b: torch_export.load_fn(p) for b, p in programs.items()}
    img_paths = []
    for ext in (".jpg", ".jpeg", ".png"):
        img_paths += glob(os.path.join(str(args.images_dir), "**", f"*{ext}"),
                          recursive=True)
    for img_path in sorted(img_paths):
        stem = Path(img_path).stem
        img = Image.open(img_path).convert("RGB")
        mask = read_mask(os.path.join(str(args.masks_dir), stem + ".png"),
                         invert=args.invert_mask)
        if mask.size != img.size:
            # read_mask shrinks a mask above 512 px, as the demo does:
            # back to the image's size, as the server's pipeline mode
            mask = mask.resize(img.size, Image.NEAREST)
        img, mask = np.asarray(img, np.uint8), np.asarray(mask, np.uint8)
        h, w = img.shape[:2]
        # pad to the smallest bucket that fits (mask pad = known)
        b = next((b for b in buckets if b >= max(h, w)), buckets[-1])
        pi = np.zeros((1, b, b, 3), np.uint8)
        pm = np.full((1, b, b, 1), 255, np.uint8)
        pi[0, :h, :w] = img
        pm[0, :h, :w, 0] = mask
        out = run[b](torch.from_numpy(pi).to(args.device),
                     torch.from_numpy(pm).to(args.device))
        Image.fromarray(out[0, :h, :w].cpu().numpy()).save(
            args.output_dir / "sample_results" / f"{stem}.png")
        print(f"inpainted {img_path}")
    return written


if __name__ == "__main__":
    main()
