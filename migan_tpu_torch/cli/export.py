"""Export CLI on the port (port of `migan_tpu/cli/export.py`; reference
scripts/export_inference_model.py): fold a trained, re-parametrized
generator into the deploy net, check the fold, and serialize it.

    python -m migan_tpu_torch.cli.export --model-path train_g.npz \
        --resolution 512 --origs-dir imgs/ --masks-dir masks/ \
        --output-dir out/ --device cuda

Inputs (--model-path): the JAX package's training-G `.npz`, a reference
`.pt` training state_dict, a reference `network-snapshot-*.pkl`
(whole-module pickle, loaded without reference code; its `G_ema` is
folded), or a training checkpoint directory of the port (`train/
checkpoint.py`: a `step_*` directory or the `weight/` directory holding
them, whose newest is taken; its `params_G_ema` is folded). The JAX
package's checkpoint directory (an orbax TrainState) needs JAX to read
and is refused, with the reason.

Outputs:
  out/models/migan.npz     folded deploy weights, the JAX package's format
  out/models/migan.pt2     `torch.export` program of the kernel chain at
                           [1, res, res, 4] float32 on --device (load it
                           after `import migan_tpu_torch.ops.kernels`)
  out/samples/...          composites of the training net (original) and
                           of the folded kernel chain (converted)
  printed "Average diff %" the fold-parity statistic (reference :163-164):
                           train-G (`const` noise) against the folded net's
                           plain forward, as the reference and the JAX
                           package compute it; then the same statistic
                           through the kernel chain and the chain's largest
                           distance from the plain folded net
"""

from __future__ import annotations

import argparse
import os
from glob import glob
from pathlib import Path

import numpy as np
import torch


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model-path", type=str, required=True,
                   help="training-G .npz, reference .pt state_dict, "
                   "reference network-snapshot-*.pkl, or a training "
                   "checkpoint directory of the port")
    p.add_argument("--origs-dir", type=Path, required=True)
    p.add_argument("--masks-dir", type=Path, required=True)
    p.add_argument("--output-dir", type=Path, required=True)
    p.add_argument("--resolution", type=int, required=True)
    p.add_argument("--num-samples", type=int, default=10)
    p.add_argument("--num-reparam-tensors", type=int, default=9)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' raises when no card is "
                   "present.")
    return p.parse_args(argv)


def _sample_input(img_path: str, masks_dir, res: int):
    """(img [res, res, 3] in [-1, 1], mask [res, res, 1] in {0, 1}, model
    input [1, res, res, 4]) with the reference's BICUBIC / NEAREST
    resizes."""
    from PIL import Image

    mask_path = os.path.join(str(masks_dir), f"{Path(img_path).stem}.png")
    img = Image.open(img_path).convert("RGB").resize((res, res),
                                                     Image.BICUBIC)
    mask = Image.open(mask_path).convert("L").resize((res, res),
                                                     Image.NEAREST)
    img_np = (np.asarray(img, np.float32) / 255.0 - 0.5) * 2
    mask_np = (np.asarray(mask, np.float32) / 255.0)[:, :, None]
    x = np.concatenate([mask_np - 0.5, img_np * mask_np], axis=-1)[None]
    return img_np, mask_np, x


def main(argv=None) -> dict:
    """Runs the CLI; returns {"diff_pct": the fold statistic (%),
    "chain_diff_pct": the same through the kernel chain,
    "chain_max_abs_diff": the chain's largest distance from the plain
    folded net}."""
    args = get_args(argv)
    from PIL import Image

    from ..export import torch_export
    from ..export.fold import diff_count, fold_generator
    from ..io import load_train_generator, save_npz
    from ..models.migan import MiganConfig, generator_apply
    from ..models.migan_inference import generator_apply as inference_apply
    from ..models.migan_kernels import KernelGenerator

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {args.device!r} requested but no CUDA "
                           "device is available")
    if dev.type == "cuda":
        # IEEE float32 on the card, as `cli.demo.load_model` sets it
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    (args.output_dir / "models").mkdir(parents=True, exist_ok=True)
    orig_dir = args.output_dir / "samples" / "original_result"
    conv_dir = args.output_dir / "samples" / "converted_result"
    orig_dir.mkdir(parents=True, exist_ok=True)
    conv_dir.mkdir(parents=True, exist_ok=True)

    cfg = MiganConfig(resolution=args.resolution, depthwise=True,
                      reparametrize=True,
                      num_reparam_tensors=args.num_reparam_tensors)
    if os.path.isdir(args.model_path):
        # a training checkpoint of the port (log/<run>/weight/step_N or
        # the weight/ dir itself): fold the EMA weights, as the reference
        # export folds a snapshot's G_ema
        from ..models.migan import Generator
        from ..train.checkpoint import extract_field, latest

        path = latest(args.model_path) or args.model_path
        print(f"extracting params_G_ema from {path}")
        try:
            state = extract_field(path, "params_G_ema")
        except (ValueError, FileNotFoundError) as e:
            raise SystemExit(str(e)) from e
        train_g = Generator(cfg)
        train_g.load_state_dict(state, strict=True)
    else:
        train_g = load_train_generator(args.model_path, cfg)
    train_g = train_g.to(dev).eval()

    print("Folding weights...")
    folded = fold_generator(train_g).eval()
    chain = KernelGenerator(folded)

    img_paths = []
    if args.num_samples > 0:      # 0 skips the dual-forward diff statistic
        for ext in (".jpg", ".jpeg", ".png"):
            img_paths += glob(os.path.join(str(args.origs_dir), "**",
                                           f"*{ext}"), recursive=True)
        img_paths = sorted(img_paths)[: args.num_samples]

    print("Calculating diff statistic...")
    diff_sum = chain_sum = 0
    chain_err = 0.0
    for img_path in img_paths:
        img_np, mask_np, x = _sample_input(img_path, args.masks_dir,
                                           args.resolution)
        x = torch.from_numpy(x).to(dev)
        with torch.no_grad():
            original = generator_apply(train_g, x, noise_mode="const")
            plain = inference_apply(folded, x)
            converted = chain(x)
        diff_sum += diff_count(original, plain)
        chain_sum += diff_count(original, converted)
        chain_err = max(chain_err, (converted - plain).abs().max().item())
        for out, outdir in ((original, orig_dir), (converted, conv_dir)):
            arr = out[0].float().cpu().numpy()
            comp = img_np * mask_np + (arr * 0.5 + 0.5) * (1 - mask_np)
            comp = np.clip(comp * 255, 0, 255).astype(np.uint8)
            Image.fromarray(comp).save(outdir / f"{Path(img_path).stem}.png")

    per = 100 / max(len(img_paths), 1) / args.resolution ** 2
    stats = {"diff_pct": diff_sum * per, "chain_diff_pct": chain_sum * per,
             "chain_max_abs_diff": chain_err}
    print(f"Average diff %: {stats['diff_pct']:.2f}%")
    print(f"Average diff % through the kernel chain: "
          f"{stats['chain_diff_pct']:.2f}% (kernel chain vs the plain folded "
          f"net: max|diff| {chain_err:.3e})")

    print("Saving folded weights (npz)...")
    save_npz(str(args.output_dir / "models" / "migan.npz"), folded)

    print("Exporting the kernel chain (torch.export)...")
    dummy = torch.zeros(1, args.resolution, args.resolution, 4,
                        device=dev)
    torch_export.save(str(args.output_dir / "models" / "migan.pt2"), chain,
                      [dummy])
    print("torch.export model exported")
    return stats


if __name__ == "__main__":
    main()
