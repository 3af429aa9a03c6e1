"""Inpainting demo CLI on the port (port of `migan_tpu/cli/demo.py`;
reference scripts/demo.py).

    python -m migan_tpu_torch.cli.demo --model-name migan-512 \
        --model-path weights.npz --images-dir imgs/ --masks-dir masks/ \
        --output-dir out/ --device cuda

Takes the JAX package's `.npz` weights or a reference `.pt` state_dict.
The MI-GAN generator runs through the kernel chain
(`models/migan_kernels.py`); on `--device cpu` the chain's fused ops take
their plain versions. `comodgan-256/512` (the distillation teacher) runs
on plain ops, as in the JAX package, with its `--ch-base`, `--ch-max`,
`--z-npy` and `--noise-mode`, through the same entry module.
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

from ..utils import tracing

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model-name", required=True,
                   help="migan-<resolution>, e.g. migan-256 or migan-512, "
                   "or comodgan-<resolution>")
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
    p.add_argument("--ch-base", type=int, default=None,
                   help="Channel bank base for comodgan-* (reference "
                   "comodgan.py Encoder/Synthesis ch_base; default 32768).")
    p.add_argument("--ch-max", type=int, default=None,
                   help="Channel cap for comodgan-* (default 512).")
    p.add_argument("--z-npy", type=str, default=None,
                   help="comodgan-*: .npy with a fixed z [512] (or [1,512]) "
                   "used for every image instead of per-call sampling, "
                   "which makes runs reproducible and comparable across "
                   "frameworks (reference comodgan.py:438-445).")
    p.add_argument("--noise-mode", choices=["random", "const", "none"],
                   default="random",
                   help="comodgan-*: synthesis noise mode; 'const' replays "
                   "the loaded noise_const buffers.")
    p.add_argument("--batch-size", type=int, default=1,
                   help="Images per forward. 1 replays the reference demo "
                   "loop; >1 overlaps host decode/encode (thread pool) "
                   "with device compute. Outputs are identical.")
    p.add_argument("--io-workers", type=int, default=8,
                   help="Host threads for decode/encode when "
                   "--batch-size > 1.")
    return p.parse_args(argv)


def load_model(model_name: str, model_path: str, dtype: str = "float32",
               device: str = "cuda", ch_base=None, ch_max=None,
               z_npy=None, noise_mode: str = "random"):
    """Returns (forward, resolution). forward: [N,H,W,4] array or tensor
    -> float32 [N,H,W,3] tensor on `device`, a `ModelForward` around:

    migan-<res>: the deploy generator through the kernel chain.
    comodgan-<res>: the Co-Mod-GAN generator on plain ops, as in the JAX
    package (`models.comodgan.CoModGANForward`), with ch_base / ch_max, a
    fixed z from `z_npy` and the noise mode.

    The load is the set-up span `entry.load`."""
    with tracing.setup_span("entry.load"):
        return _load_model(model_name, model_path, dtype, device, ch_base,
                           ch_max, z_npy, noise_mode)


def _load_model(model_name, model_path, dtype, device, ch_base, ch_max,
                z_npy, noise_mode):
    from ..io import load_weights
    from ..models.migan_inference import GeneratorConfig
    from ..models.migan_kernels import KernelGenerator

    m = re.fullmatch(r"(migan|comodgan)-(\d+)", model_name)
    res = int(m.group(2)) if m else 0
    if res < 16 or res & (res - 1):
        raise ValueError(f"Unsupported model name: {model_name}")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA "
                           "device is available")
    if dev.type == "cuda":
        # float32 means IEEE float32 on the card, as in the kernels: cuDNN
        # would run the chain's float32 plain convs (fromrgb, the 4x4
        # torgb, the rgb pyramid) and the detectors of cli/evaluate.py in
        # TF32. A process-wide setting; bf16 work is not affected by it.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    dt = DTYPES[dtype]
    if m.group(1) == "comodgan":
        from ..models.comodgan import CoModGANConfig, load_comodgan_forward

        z = None
        if z_npy is not None:
            z = np.load(z_npy)
            z_dim = CoModGANConfig().z_dim
            if z.size != z_dim:
                raise SystemExit(
                    f"--z-npy must hold one latent of {z_dim} values "
                    f"([{z_dim}] or [1, {z_dim}]); got shape {z.shape}. It "
                    "is broadcast over the batch; per-image latents are "
                    "not supported.")
            z = z.reshape(1, z_dim).astype(np.float32)
        chain, res = load_comodgan_forward(
            model_name, model_path, ch_base=ch_base, ch_max=ch_max, z=z,
            noise_mode=noise_mode, device=device)
        return ModelForward(chain, dev, dt), res
    generator = load_weights(model_path, GeneratorConfig(resolution=res))
    chain = KernelGenerator(generator.to(device=dev, dtype=dt).eval())
    return ModelForward(chain, dev, dt), res


class ModelForward(torch.nn.Module):
    """`load_model`'s forward: [N,H,W,4] array or tensor -> float32
    [N,H,W,3] tensor on the chain's device, through the chain (MI-GAN's
    kernel chain, or Co-Mod-GAN's generator). A module, so that
    `torch.export` takes it with the chain's weights.

    Spans: `entry.forward`, with `entry.h2d` (the input's copy) and the
    generator's spans inside; the instance's first call, which pays the
    device's lazy set-up, is the set-up span `entry.first_forward`
    instead."""

    def __init__(self, chain, device: torch.device, dtype: torch.dtype):
        super().__init__()
        self.chain, self.device, self.dtype = chain, device, dtype
        self.first_call = True

    def forward(self, x) -> torch.Tensor:
        if self.first_call and not torch.compiler.is_compiling():
            self.first_call = False
            with tracing.setup_span("entry.first_forward"):
                return self._forward(x)
        with tracing.span("entry.forward"):
            return self._forward(x)

    def _forward(self, x) -> torch.Tensor:
        with tracing.span("entry.h2d"):
            x = torch.as_tensor(x).to(device=self.device, dtype=self.dtype)
        return self.chain(x.contiguous()).float()


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
                                     args.dtype, args.device,
                                     ch_base=args.ch_base,
                                     ch_max=args.ch_max, z_npy=args.z_npy,
                                     noise_mode=args.noise_mode)
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
