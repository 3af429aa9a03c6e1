"""Batched FID + LPIPS evaluation on the port (port of
`migan_tpu/cli/evaluate.py`; reference scripts/evaluate_fid_lpips.py):
the generator through the kernel chain (`cli.demo.load_model`), the
detectors in plain PyTorch.

    python -m migan_tpu_torch.cli.evaluate --model-name migan-512 \
        --model-path weights.npz --real-dir images/ [--mask-dir masks/] \
        [--batch-size 8] --inception-weights pt_inception.pth \
        --lpips-weights alex.pth --device cuda

The protocol is the JAX package's:
  - np.random.seed(0) / random.seed(0) before mask synthesis
  - images resized BICUBIC to the model's resolution; masks from
    --mask-dir (255 = known) or drawn on the fly (RandomMask)
  - composite = mask * img + (1 - mask) * output; both metrics on [0, 1]
  - FID from the full activation arrays (np.mean / np.cov, scipy sqrtm)

Data parallel (`migan_tpu/cli/evaluate.py:180-292`): launched by
`torch.distributed.run` (``python -m torch.distributed.run
--nproc-per-node P -m migan_tpu_torch.cli.evaluate ... --data-parallel``),
the CLI joins the process group (NCCL on `cuda:LOCAL_RANK`, gloo with
`--device cpu`) and rank p scores items p, p + P, ... (extend-padded to
an equal count); the per-item LPIPS and activations are all-gathered and
re-interleaved into item order, rank 0 computes the FID and writes the
real-activations cache. On-the-fly masks then come from the per-item
stream at the items' single-process positions (as --num-workers > 1
gives them). --data-parallel without the launcher's env is refused.

Detector weights are .pth/.pt state_dicts (pytorch_fid InceptionV3, lpips
alex). --allow-random-detector runs with random detector weights (a
plumbing check; the numbers mean nothing).
"""

from __future__ import annotations

import argparse
import os.path as osp
import random
import time
from pathlib import Path

import numpy as np
import torch

from .. import parallel
from ..data.masks import random_mask_uint8

DETECTOR_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model-name", type=str, required=True)
    p.add_argument("--model-path", type=str, required=True)
    p.add_argument("--real-dir", type=Path, required=True)
    p.add_argument("--mask-dir", type=Path, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' raises when no card is "
                   "present.")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--num-workers", type=int, default=1,
                   help="loader threads. 1 keeps on-the-fly masks on the "
                   "sequential seed-0 global stream (the reference "
                   "protocol); >1 switches to the per-item seeded stream: "
                   "deterministic, but another stream than the reference's")
    p.add_argument("--dtype", choices=["float32", "bfloat16"],
                   default="float32")
    p.add_argument("--inception-weights", type=str, default=None)
    p.add_argument("--lpips-weights", type=str, default=None)
    p.add_argument("--allow-random-detector", action="store_true")
    p.add_argument("--detector-dtype", choices=sorted(DETECTOR_DTYPES),
                   default="float32",
                   help="bfloat16 runs the detector conv stacks in bf16 "
                   "(shifts FID slightly; keep float32 when comparing "
                   "against published numbers).")
    p.add_argument("--max-items", type=int, default=None)
    p.add_argument("--real-acts-cache", type=str, default=None,
                   help="npz path caching the real images' Inception "
                   "activations across runs. The first run computes and "
                   "saves them; later runs skip the real-side detector "
                   "pass. Delete the file when the real set or the "
                   "detector weights change.")
    p.add_argument("--data-parallel", action="store_true",
                   help="shard the items over the ranks of the "
                   "torch.distributed group (launch with "
                   "torch.distributed.run); refused without one. Under a "
                   "launcher the items are sharded whether or not it is "
                   "given.")
    return p.parse_args(argv)


class InferenceDataset:
    """reference evaluate_fid_lpips.py:124-165 (NHWC).

    On-the-fly masks draw from `rng` when the DataLoader passes a per-item
    one (num_workers > 1), and from the seed-0 global np.random stream
    otherwise (num_workers = 1, the reference protocol)."""

    IMG_EXT = {".jpg", ".jpeg", ".JPG", ".JPEG", ".png", ".PNG"}
    supports_rng = True

    def __init__(self, real_dir: Path, mask_dir=None, resolution=None):
        self.img_paths = [p for p in Path(real_dir).iterdir()
                          if p.suffix in self.IMG_EXT]
        self.mask_dir = mask_dir
        self.resolution = resolution

    def __len__(self):
        return len(self.img_paths)

    def __getitem__(self, index, rng=None):
        from PIL import Image

        img_path = self.img_paths[index]
        img = Image.open(img_path).convert("RGB")
        if img.size != (self.resolution, self.resolution):
            img = img.resize((self.resolution, self.resolution),
                             Image.BICUBIC)
        if self.mask_dir is not None:
            mask = Image.open(Path(self.mask_dir) / f"{img_path.stem}.png")
            mask = mask.convert("L").resize(
                (self.resolution, self.resolution), Image.NEAREST)
        else:
            mask = Image.fromarray(random_mask_uint8(
                self.resolution, rng=np.random if rng is None else rng
            )).convert("L")
        img_np = np.asarray(img, np.float32) * 2 / 255 - 1
        mask_np = (np.asarray(mask)[:, :, None] // 255).astype(np.float32)
        x = np.concatenate([mask_np - 0.5, img_np * mask_np], axis=-1)
        return x, img_np, mask_np, img_path.stem


def load_detectors(args, device):
    """(inception fn, lpips fn) on `device`: NHWC [0, 1] -> [N, 2048]
    features, and (imgs, imgs) -> [N] distances."""
    from ..evalx.inception import (
        import_inception_state_dict, inception_apply, inception_init,
    )
    from ..evalx.lpips import import_lpips_state_dict, lpips_init
    from ..io.torch_import import load_torch_state_dict

    if args.inception_weights:
        inc = import_inception_state_dict(
            load_torch_state_dict(args.inception_weights))
    elif args.allow_random_detector:
        print("WARNING: random Inception weights — FID is meaningless")
        inc = inception_init(0)
    else:
        raise SystemExit("--inception-weights required "
                         "(or --allow-random-detector for smoke tests)")
    if args.lpips_weights:
        lp = import_lpips_state_dict(
            load_torch_state_dict(args.lpips_weights))
    elif args.allow_random_detector:
        print("WARNING: random LPIPS weights — LPIPS is meaningless")
        lp = lpips_init(1)
    else:
        raise SystemExit("--lpips-weights required "
                         "(or --allow-random-detector for smoke tests)")
    inc, lp = inc.to(device), lp.to(device)
    cd = DETECTOR_DTYPES[args.detector_dtype]
    return (lambda x: inception_apply(inc, x, compute_dtype=cd),
            lambda a, b: lp(a, b, normalize=True, compute_dtype=cd))


def score_batch(forward, inception, lp, x, imgs, masks, device,
                real: bool = True):
    """The device work of one batch: generator, composite, both metrics on
    [0, 1] images. Returns (per-image LPIPS, real activations or None,
    composite activations), left on `device`."""
    out = forward(x)
    imgs_t = torch.as_tensor(imgs, device=device)
    masks_t = torch.as_tensor(masks, device=device)
    composed = masks_t * imgs_t + (1 - masks_t) * out
    imgs01 = (imgs_t * 0.5 + 0.5).clamp(0, 1)
    comp01 = (composed * 0.5 + 0.5).clamp(0, 1)
    return (lp(imgs01, comp01), inception(imgs01) if real else None,
            inception(comp01))


def main(argv=None, details: dict = None):
    """Returns (FID, mean LPIPS). With a `details` dict, also fills in
    the per-image LPIPS ("lpips"), the activations ("real_acts",
    "fake_acts"), the items ("n"), the loop's seconds ("seconds"), the
    seconds it waited for the loader ("waited") and per batch (seconds
    from the loop's start to the batch's end, its items, the seconds it
    waited for the loader) ("batches")."""
    args = get_args(argv)
    device = parallel.maybe_initialize_distributed(args.device)
    try:
        return _evaluate(args, device, details)
    finally:
        parallel.destroy()


def _zipzap(a: np.ndarray, n: int) -> np.ndarray:
    """Every rank's per-item rows (rank p holds items p, p + P, ...) in
    item order, the extend padding cut: an all-gather, then the rows
    re-interleaved."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(
        parallel.collective_device())
    g = parallel.all_gather_rows(t).cpu().numpy()
    g = g.reshape(parallel.world(), *a.shape).swapaxes(0, 1)   # [m, P, ...]
    return g.reshape(-1, *a.shape[1:])[:n]


def _evaluate(args, device: torch.device, details):
    sharded = parallel.is_initialized()
    if args.data_parallel and not sharded:
        raise SystemExit("--data-parallel shards the items over the ranks "
                         "of a torch.distributed group: launch with python "
                         "-m torch.distributed.run --nproc-per-node P -m "
                         "migan_tpu_torch.cli.evaluate ...")
    world, rank = parallel.world(), parallel.rank()
    np.random.seed(0)
    random.seed(0)

    from ..data.sampler import DataLoader, ShardSampler
    from ..evalx.fid import fid_from_feature_arrays
    from .demo import load_model

    print(parallel.describe(device))
    forward, resolution = load_model(args.model_name, args.model_path,
                                     args.dtype, device)
    inception, lp = load_detectors(args, device)

    ds = InferenceDataset(args.real_dir, args.mask_dir, resolution)
    n = len(ds) if args.max_items is None else min(len(ds), args.max_items)
    indices = (ShardSampler(n, world, rank, shuffle=False,
                            extend=True).epoch_indices(0) if sharded
               else range(n))
    # more than one rank must not draw masks from the global stream: each
    # would draw the same sequence for other items
    dl = DataLoader(ds, batch_size=args.batch_size, indices=indices,
                    num_workers=args.num_workers, drop_last=False,
                    seed=0 if args.num_workers > 1 or world > 1 else None,
                    start_position=rank, position_stride=world)

    cache_path = args.real_acts_cache
    cached_real = None
    if cache_path and osp.isfile(cache_path):
        z = np.load(cache_path)
        if z["acts"].shape[0] == n:
            cached_real = z["acts"]
            print(f"real activations from cache: {cache_path}")
        else:
            print(f"ignoring {cache_path}: has {z['acts'].shape[0]} "
                  f"items, need {n}")

    if device.type == "cuda":
        # first calls on the card (cuDNN's choice of algorithms, the
        # kernels' plans) at the batch's shapes, outside the timed loop
        zeros = torch.zeros(args.batch_size, resolution, resolution, 4,
                            device=device)
        score_batch(forward, inception, lp, zeros, zeros[..., :3],
                    zeros[..., :1], device)[2].cpu()

    print("Starting the inference... ")
    t0 = time.perf_counter()
    t_prev, waited, batch_log = t0, 0.0, []
    lpips_vals, real_acts, fake_acts = [], [], []
    for x, imgs, masks, names in dl:
        wait = time.perf_counter() - t_prev
        waited += wait
        d_lp, d_real, d_fake = score_batch(forward, inception, lp, x, imgs,
                                           masks, device, cached_real is None)
        lpips_vals.extend(d_lp.cpu().numpy().tolist())
        if d_real is not None:
            real_acts.append(d_real.cpu().numpy())
        fake_acts.append(d_fake.cpu().numpy())
        t_prev = time.perf_counter()
        batch_log.append((t_prev - t0, len(names), wait))
    seconds = time.perf_counter() - t0

    lpips_vals = np.asarray(lpips_vals, np.float64)
    fake_acts = np.concatenate(fake_acts)
    real_acts = (cached_real if cached_real is not None
                 else np.concatenate(real_acts))
    if sharded:
        lpips_vals, fake_acts = _zipzap(lpips_vals, n), _zipzap(fake_acts, n)
        if cached_real is None:
            real_acts = _zipzap(real_acts, n)
    if cache_path and cached_real is None and rank == 0:
        np.savez(cache_path, acts=real_acts)
        print(f"cached real activations -> {cache_path}")

    fid_value = None
    if rank == 0:
        print("Calculating Frechet distance. Please wait... ")
        fid_value = fid_from_feature_arrays(real_acts, fake_acts)
    fid_value = parallel.broadcast_scalar(fid_value)
    lpips_mean = float(np.mean(lpips_vals))
    print("FID:", fid_value)
    print("LPIPS: ", lpips_mean)
    print(f"evaluated {len(indices)} images in {seconds:.2f}s "
          f"({len(indices) / seconds:.2f} img/s, {device}); {waited:.2f}s "
          "of it waiting for the loader")
    if details is not None:
        details.update(lpips=lpips_vals,
                       real_acts=real_acts, fake_acts=fake_acts, n=n,
                       seconds=seconds, waited=waited, batches=batch_log)
    return fid_value, lpips_mean


if __name__ == "__main__":
    main()
