"""Training entry point of the port (port of `migan_tpu/cli/train.py`;
reference main.py + run.sh).

    python -m migan_tpu_torch.cli.train --experiment migan_places256 \
        [--device cuda] [--seed 0] [--signature tag ...] \
        [--resume-path log/.../weight] [--max-steps N] [--set a.b=v ...]

One process trains on one device: the card by default (`--device cuda`
raises when there is none), `--device cpu` for the CPU. On a card float32
means IEEE float32 (TF32 off, as in the other CLIs of the port). The
flags are the JAX CLI's, plus `--device`.

Data parallel: launch one process per device with `torch.distributed.run`
(e.g. ``python -m torch.distributed.run --standalone --nproc-per-node 4
-m migan_tpu_torch.cli.train ...``); each rank trains on `cuda:LOCAL_RANK`
over NCCL (gloo with `--device cpu`), `train.batch_size` stays the global
batch (`batch_size_per_device` is per rank), and rank 0 writes the run
directory.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import shutil

import torch

from .. import parallel
from ..utils.config import (ConfigBanks, apply_overrides, cfg_to_debug,
                            cfg_unique_holder, get_experiment_id,
                            split_batch)
from ..utils.logging import print_log, set_log_file


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--experiment", type=str, required=True)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--config-root", type=str, default="configs")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--signature", nargs="+", type=str, default=None)
    p.add_argument("--resume-path", type=str, default=None)
    p.add_argument("--max-steps", type=int, default=None,
                   help="stop after N optimizer steps (smoke runs)")
    p.add_argument("--model-g", type=str, default=None,
                   help="swap model_g from the model bank "
                        "(reference --model capability)")
    p.add_argument("--model-d", type=str, default=None,
                   help="swap model_d from the model bank")
    p.add_argument("--dataset", type=str, default=None,
                   help="swap train.dataset (and eval.dataset if present) "
                        "from the dataset bank")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="PATH=VALUE",
                   help="override any config path, YAML-parsed value "
                        "(e.g. --set train.g_opt_kwargs.lr=1e-4); "
                        "repeatable")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' raises when no card is "
                        "present")
    return p.parse_args(argv)


def cfg_initiates(cfg, args):
    """Log-dir naming, code snapshot and seeds (reference lib/
    cfg_helper.py:383-585, condensed)."""
    import yaml

    cfgt = cfg["train"]
    if args.seed is not None:
        cfg.setdefault("env", {})["rnd_seed"] = args.seed
    if args.signature:
        cfgt["signature"] = list(args.signature)
    if args.resume_path:
        cfgt["resume_path"] = args.resume_path
    if args.debug:
        cfg_to_debug(cfg)
    if cfgt.get("experiment_id") is None:
        # every rank names the run directory after rank 0's clock
        cfgt["experiment_id"] = int(parallel.broadcast_scalar(
            get_experiment_id()))
    split_batch(cfgt, parallel.world())

    sig = "-".join(str(s) for s in (cfgt.get("signature") or []))
    model_name = cfg.get("model_g", {}).get("name", "model")
    run_name = f"{cfgt['experiment_id']}-{model_name}"
    if sig:
        run_name += f"-{sig}"
    log_root = cfg.get("env", {}).get("log_root_dir", "log")
    log_dir = osp.join(log_root, run_name)
    cfgt["log_dir"] = log_dir
    os.makedirs(log_dir, exist_ok=True)
    if parallel.rank() != 0:
        return cfg          # rank 0 alone writes the log, code and config
    set_log_file(osp.join(log_dir, "train.log"))

    # code snapshot (reference cfg_helper.py:551-563)
    if cfgt.get("save_code"):
        code_dir = osp.join(log_dir, "code")
        if not osp.isdir(code_dir):
            src = osp.dirname(osp.dirname(osp.abspath(__file__)))
            shutil.copytree(src, osp.join(code_dir, "migan_tpu_torch"),
                            ignore=shutil.ignore_patterns("__pycache__"))

    # the resolved config, for an exact resume
    with open(osp.join(log_dir, "config.yaml"), "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    return cfg


def main(argv=None):
    """Runs the CLI; returns the final `TrainState`."""
    args = get_args(argv)
    device = parallel.maybe_initialize_distributed(args.device)
    try:
        return _train(args, device)
    finally:
        parallel.destroy()


def _train(args, device: torch.device):
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {args.device!r} requested but no "
                               "CUDA device is available")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    banks = ConfigBanks(args.config_root)
    cfg = banks.experiment(args.experiment)
    # subtree swaps from the banks (reference --model/--dataset,
    # cfg_helper.py:308-319), then the dotted-path --set overrides
    if args.model_g:
        cfg["model_g"] = banks.model(args.model_g)
    if args.model_d:
        cfg["model_d"] = banks.model(args.model_d)
    if args.dataset:
        ds = banks.dataset(args.dataset)
        if "train" in cfg:
            cfg["train"]["dataset"] = ds
        if "eval" in cfg:
            cfg["eval"]["dataset"] = ds
    apply_overrides(cfg, args.overrides)
    cfg = cfg_initiates(cfg, args)
    cfg_unique_holder().save_cfg(cfg)

    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print_log(f"device: {device} ({name})")
    print_log(f"experiment: {args.experiment} -> {cfg['train']['log_dir']}")

    from ..train.loop import train_stage

    return train_stage(cfg, max_steps=args.max_steps, device=device)


if __name__ == "__main__":
    main()
