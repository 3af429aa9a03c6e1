"""Inpainting demo CLI on the port (port of `migan_tpu/cli/demo.py`;
reference scripts/demo.py).

    python -m migan_tpu_torch.cli.demo --model-name migan-512 \
        --model-path weights.npz --images-dir imgs/ --masks-dir masks/ \
        --output-dir out/ --device cuda

Takes the JAX package's `.npz` weights or a reference `.pt` state_dict.
The generator runs through the kernel chain (`models/migan_kernels.py`);
on `--device cpu` the chain's fused ops take their plain versions.
Pre/post-processing is the port's `data/preprocess.py` (numpy and PIL),
imported where files are read.
"""

from __future__ import annotations

import argparse
import os
import re
import time
from collections import deque
from glob import glob
from pathlib import Path

import numpy as np
import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model-name", required=True,
                   help="migan-<resolution>, e.g. migan-256 or migan-512")
    p.add_argument("--model-path", required=True,
                   help="Weights (.npz of migan_tpu or .pt state_dict).")
    p.add_argument("--images-dir", type=Path, required=True)
    p.add_argument("--masks-dir", type=Path, required=True)
    p.add_argument("--invert-mask", action="store_true",
                   help="Invert mask? (make 0-known, 1-hole)")
    p.add_argument("--output-dir", type=Path, required=True)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' raises when no card is "
                   "present.")
    p.add_argument("--dtype", choices=sorted(DTYPES), default="float32")
    p.add_argument("--batch-size", type=int, default=1,
                   help="Images per forward. 1 replays the reference demo "
                   "loop; >1 overlaps host decode/encode (thread pool) "
                   "with device compute. Outputs are identical.")
    p.add_argument("--io-workers", type=int, default=8,
                   help="Host threads for decode/encode when "
                   "--batch-size > 1.")
    return p.parse_args(argv)


def load_model(model_name: str, model_path: str, dtype: str = "float32",
               device: str = "cuda"):
    """Returns (forward, resolution). forward: [N,H,W,4] array or tensor
    -> float32 [N,H,W,3] tensor on `device`."""
    from ..io import load_weights
    from ..models.migan_inference import GeneratorConfig
    from ..models.migan_kernels import KernelGenerator

    m = re.fullmatch(r"migan-(\d+)", model_name)
    res = int(m.group(1)) if m else 0
    if res < 16 or res & (res - 1):
        raise ValueError(f"Unsupported model name: {model_name}")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA "
                           "device is available")
    if dev.type == "cuda":
        # float32 means IEEE float32 on the card, as in the kernels: cuDNN
        # would run the float32 convs below the kernel levels (and the
        # detectors of cli/evaluate.py) in TF32. A process-wide setting;
        # bf16 work is not affected by it.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    dt = DTYPES[dtype]
    generator = load_weights(model_path, GeneratorConfig(resolution=res))
    chain = KernelGenerator(generator.to(device=dev, dtype=dt).eval())

    def forward(x):
        x = torch.as_tensor(x).to(device=dev, dtype=dt).contiguous()
        return chain(x).float()

    return forward, res


def _list_images(images_dir) -> list:
    paths = []
    for ext in (".jpg", ".jpeg", ".png"):
        paths += glob(os.path.join(str(images_dir), "**", f"*{ext}"),
                      recursive=True)
    return sorted(paths)


def _load_input(img_path, masks_dir, resolution, invert_mask):
    """(image, mask) resized as the reference demo does, and the model
    input [1, res, res, 4]."""
    from PIL import Image

    from ..data.preprocess import preprocess, read_mask, resize_max

    stem = "".join(os.path.basename(img_path).split(".")[:-1])
    img = resize_max(Image.open(img_path).convert("RGB"),
                     max_size=resolution)
    mask = read_mask(os.path.join(str(masks_dir), stem + ".png"),
                     invert=invert_mask)
    mask = resize_max(mask, max_size=resolution, interpolation=Image.NEAREST)
    return img, mask, preprocess(img, mask, resolution)


def _save(result, img_path, img_resized, mask_resized, output_dir):
    from ..data.preprocess import postprocess

    composed = postprocess(result, img_resized, mask_resized)
    composed.save(Path(output_dir) / f"{Path(img_path).stem}.png")


def run_batched(forward, resolution: int, img_paths: list, masks_dir,
                output_dir, *, invert_mask: bool = False, batch_size: int = 8,
                io_workers: int = 8) -> int:
    """Batched loop: decode/preprocess on a thread pool, run full
    [B, res, res, 4] batches (the tail is zero-padded), postprocess/encode
    on the pool, with one batch in flight so host IO overlaps the device.
    Outputs equal the per-image loop's: the generator has no cross-batch
    ops. Returns the number of images written."""
    from concurrent.futures import ThreadPoolExecutor

    n_written = 0
    # bound host memory: at most ~2 batches of decoded inputs and saves
    max_inflight = max(2 * batch_size, 2 * io_workers)
    with ThreadPoolExecutor(max_workers=io_workers) as pool:

        def _loads():
            inflight = deque()
            for p in img_paths:
                inflight.append(pool.submit(
                    _load_input, p, masks_dir, resolution, invert_mask))
                if len(inflight) >= max_inflight:
                    yield inflight.popleft().result()
            while inflight:
                yield inflight.popleft().result()

        def _batches():
            metas, xs = [], []
            for path, (img, mask, x) in zip(img_paths, _loads()):
                metas.append((path, img, mask))
                xs.append(x)
                if len(xs) == batch_size:
                    yield metas, np.concatenate(xs, axis=0)
                    metas, xs = [], []
            if xs:
                xs += [np.zeros_like(xs[0])] * (batch_size - len(xs))
                yield metas, np.concatenate(xs, axis=0)

        saves = deque()

        def _flush_saves(bound):
            nonlocal n_written
            while len(saves) > bound:
                saves.popleft().result()
                n_written += 1

        def _submit_saves(y, metas):
            res_np = y.cpu().numpy()          # waits for the device result
            for i, (path, img, mask) in enumerate(metas):
                saves.append(pool.submit(_save, res_np[i], path, img, mask,
                                         output_dir))
            _flush_saves(max_inflight)

        pending = None
        for metas, x in _batches():
            y = forward(x)                    # queued on the device
            if pending is not None:
                _submit_saves(*pending)
            pending = (y, metas)
        if pending is not None:
            _submit_saves(*pending)
        _flush_saves(0)
    return n_written


def main(argv=None):
    args = get_args(argv)
    args.output_dir.mkdir(parents=True, exist_ok=True)
    forward, resolution = load_model(args.model_name, args.model_path,
                                     args.dtype, args.device)
    img_paths = _list_images(args.images_dir)

    if args.batch_size > 1:
        t0 = time.perf_counter()
        n = run_batched(forward, resolution, img_paths, args.masks_dir,
                        args.output_dir, invert_mask=args.invert_mask,
                        batch_size=args.batch_size,
                        io_workers=args.io_workers)
        dt = time.perf_counter() - t0
        print(f"inpainted {n} images in {dt:.2f}s "
              f"({n / dt:.1f} img/s end-to-end)")
        return

    for img_path in img_paths:
        img, mask, x = _load_input(img_path, args.masks_dir, resolution,
                                   args.invert_mask)
        result = forward(x).cpu().numpy()[0]
        _save(result, img_path, img, mask, args.output_dir)
        print(f"inpainted {img_path}")


if __name__ == "__main__":
    main()
