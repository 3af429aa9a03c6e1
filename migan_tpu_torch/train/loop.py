"""Training orchestration: the tick loop, on one device per rank.

Port of `migan_tpu/train/loop.py::train_stage` (reference lib/experiments/
migan_default.py:132-597): the phase schedule with lazy R1, the EMA, tick
maintenance (status line, stats.jsonl, a best-effort TensorBoard writer,
image grids, checkpoints) and resume.

Resume is stream-exact, as in the JAX package: the sampler skips the
items the restored step count has consumed, the per-item mask and flip
RNG continues at the same absolute item positions, and each step's noise
comes from a `torch.Generator` seeded from (seed, absolute step index),
so a killed and resumed run replays the uninterrupted one.

`train.steps_per_call` k > 1 (`migan_tpu/train/loop.py:345-358,393-444`):
the loop buffers k batches, stages them to the device in one copy and
makes one call of `make_fused_train_step` (CUDA-graph replays on a card).
In both modes the steps' stats stay on the device until the tick
boundary; there they are averaged over the ranks and read in one go,
R1's keys dropped for the steps where R1 did not run. `batch_idx` and
the images seen advance by k per call, so ticks, snapshots and
checkpoints fall after whole calls, as in the JAX package. The k steps draw the sequential loop's noise seeds,
so both modes train on one stream.

Data parallelism (`migan_tpu/train/loop.py:266-337`): `train.batch_size`
is the global batch, split evenly over the ranks of a torch.distributed
group. Rank p loads, in blocks of local_batch / grad_accum_rounds items,
the rows of each global round that the single-process stream puts there
(`InfiniteSampler(block=...)`, the loader's block-strided positions), so
that P ranks train on the single-process stream. Rank 0 alone writes the
grids, `stats.jsonl`, TensorBoard and checkpoints (the others wait at a
barrier after each checkpoint) and runs the metrics, whose FID it
broadcasts, so every rank takes the same best-checkpoint decision.

The metric branch (reference migan_default.py:462-490): every
`snapshot.evaluate` ticks (from tick 1) each of `train.metrics` runs on
`eval.dataset` with the EMA generator, its result goes to
`metric-<name>.jsonl` under the run directory, the first metric's FID to
the log and `stats.jsonl` as `Metrics/fid`, and the lowest FID so far is
kept as the one checkpoint under `weight/best/`. As in the JAX package, a
resumed run starts with no best FID.
"""

from __future__ import annotations

import copy
import itertools
import json
import os
import os.path as osp
import shutil
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import parallel
from ..utils import stats as training_stats
from ..utils.logging import print_log
from . import checkpoint as ckpt
from .loss import KDConfig, LossConfig
from .train_step import (R1_KEYS, R1_RAN, OptConfig, TrainConfig,
                         TrainState, full_stats, init_train_state,
                         make_fused_train_step, make_train_step)


def _train_config_from_cfg(cfgt: Dict[str, Any]) -> TrainConfig:
    def opt(section, reg_interval):
        kw = cfgt[section]
        return OptConfig(lr=kw["lr"], beta1=kw["betas"][0],
                         beta2=kw["betas"][1], eps=float(kw["eps"]),
                         reg_interval=reg_interval)

    kd = None
    kd_kwargs = cfgt.get("image_level_kd_kwargs")
    if kd_kwargs and kd_kwargs.get("use_image_level_kd"):
        kd = KDConfig(start_resolution=kd_kwargs["start_resolution"],
                      weight=kd_kwargs["weight"])
    return TrainConfig(
        g_opt=opt("g_opt_kwargs", cfgt.get("g_reg_interval")),
        d_opt=opt("d_opt_kwargs", cfgt.get("d_reg_interval")),
        loss=LossConfig(r1_gamma=cfgt["loss_kwargs"]["r1_gamma"], kd=kd),
        batch_size=cfgt["batch_size"],
        ema_kimg=cfgt.get("ema_kimg", 20),
        ema_rampup=cfgt.get("ema_rampup"),
        grad_accum_rounds=cfgt.get("grad_accum_rounds", 1),
    )


def _make_teacher(cfgt: Dict[str, Any], device):
    """The Co-Mod-GAN teacher, if distillation is configured and its file
    exists (reference loss.py:55-121): ``(apply_fn, module)``, the module
    frozen on `device`. The file is the JAX package's `.npz` or a
    reference state_dict."""
    kd_kwargs = cfgt.get("image_level_kd_kwargs")
    if not (kd_kwargs and kd_kwargs.get("use_image_level_kd")):
        return None
    path = kd_kwargs.get("teacher1_path")
    if not path or not osp.isfile(path):
        print_log(f"KD teacher not found at {path!r} — "
                  "training WITHOUT distillation")
        return None
    from ..models.comodgan import (CoModGANConfig, load_comodgan,
                                   make_teacher_apply)

    cfg = CoModGANConfig(resolution=kd_kwargs.get("inference_resolution",
                                                  256))
    module = load_comodgan(path, cfg).to(device).eval().requires_grad_(False)
    print_log(f"Loaded teacher 1 (CoModGAN) from {path}")
    return make_teacher_apply(cfg), module


def _save_image_grid(batch_nhwc: np.ndarray, path: str, grid=(8, 6)):
    """[-1, 1] NHWC float -> tiled uint8 PNG (reference draw_functor,
    migan_default.py:43-129)."""
    from PIL import Image

    gw, gh = grid
    n, h, w, c = batch_nhwc.shape
    canvas = np.zeros((gh * h, gw * w, c), np.uint8)
    for i in range(min(n, gw * gh)):
        img = np.clip(batch_nhwc[i] * 127.5 + 127.5, 0, 255).astype(np.uint8)
        r, cc = divmod(i, gw)
        canvas[r * h:(r + 1) * h, cc * w:(cc + 1) * w] = img
    Image.fromarray(canvas.squeeze()).save(path)


def _resource_stats(device: torch.device) -> Dict[str, float]:
    """Host RSS (when psutil is installed) and, on a card, the allocator's
    current and peak device memory (reference Resources/* stats,
    migan_default.py:444-448)."""
    out: Dict[str, float] = {}
    try:
        import psutil
    except ImportError:
        psutil = None
    if psutil is not None:
        out["Resources/cpu_mem_gb"] = (
            psutil.Process(os.getpid()).memory_info().rss / 2 ** 30)
    if device.type == "cuda":
        out["Resources/peak_device_mem_gb"] = (
            torch.cuda.max_memory_allocated(device) / 2 ** 30)
        out["Resources/device_mem_gb"] = (
            torch.cuda.memory_allocated(device) / 2 ** 30)
    return out


def _make_tb_writer(log_dir: str):
    """TensorBoard scalars (reference migan_default.py:578-585),
    best-effort: stats.jsonl is the record; None when no writer can be
    made. tensorboardX first, as the JAX package: torch's writer imports
    TensorFlow where it is installed."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            print_log(f"tensorboard unavailable ({e}); jsonl only")
            return None
    return SummaryWriter(log_dir=log_dir)


def _encode_wire(x: np.ndarray, m: np.ndarray, wire: str):
    """Host side of the batch wire format (`train_step.decode_batch`):
    'u8' ships images as round((x + 1) 127.5) uint8 (clipped to [-1, 1])
    and masks as 0/1 uint8, 4x fewer bytes; 'f32' as they are."""
    if wire == "u8":
        return (np.clip((x + 1.0) * 127.5 + 0.5, 0, 255).astype(np.uint8),
                m.astype(np.uint8))
    return x, m


def _build_metric_ctx(cfg: Dict[str, Any], device) -> Optional[dict]:
    """The metric branch's detector, dataset and settings (reference
    migan_default.py:462-490), or None when the experiment configures no
    metric or no eval dataset, or no detector: `eval.inception_weights`
    (either FID flavor, told by its weight names; `eval.inception_flavor`
    to insist on one), else random weights with
    `eval.allow_random_detector` (the evaluate CLI's
    --allow-random-detector: the branch runs end to end, its FIDs mean
    nothing), else it is skipped with a log line saying so."""
    metrics = cfg["train"].get("metrics") or []
    eval_cfg = cfg.get("eval") or {}
    if not metrics or "dataset" not in eval_cfg:
        return None
    from ..data.factory import get_dataset
    from ..evalx.inception import (inception_init, load_inception_weights,
                                   make_detector)

    weights = eval_cfg.get("inception_weights")
    if weights and osp.isfile(weights):
        # the reference's training-time FID uses NVIDIA's TF-named
        # detector, whose FIDs differ from pytorch_fid's
        model, flavor = load_inception_weights(
            weights, eval_cfg.get("inception_flavor", "auto"))
    elif eval_cfg.get("allow_random_detector"):
        print_log(f"WARNING: random Inception weights for training-time "
                  f"metrics (eval.inception_weights: {weights!r}) — FID "
                  f"values are meaningless (plumbing only)")
        model, flavor = inception_init(0), "pytorch_fid"
    else:
        print_log(f"metrics configured but no inception_weights found "
                  f"({weights!r}) — skipping metric evaluation (set "
                  f"eval.inception_weights or eval.allow_random_detector)")
        return None
    print_log(f"training-time FID detector flavor: {flavor}")
    return {"metrics": metrics,
            "detector": make_detector(model.to(device), flavor),
            "dataset": get_dataset(eval_cfg["dataset"]),
            "detector_tag": f"inception-{flavor}",
            "dataset_tag": eval_cfg["dataset"].get("name", ""),
            "batch_size": eval_cfg.get("batch_size", 32),
            "max_items": eval_cfg.get("max_items"), "device": device}


def _run_metrics(state: TrainState, ctx: dict, log_dir: str
                 ) -> Optional[float]:
    """Runs the configured metrics on the EMA generator (const noise);
    returns the first metric's FID. The generator is a copy of the EMA,
    made at the first evaluation of the run and loaded with the EMA's
    current weights at each, so that evaluation never touches the
    training state."""
    from ..evalx import metrics as metric_main
    from ..models.migan import generator_apply

    if "G" not in ctx:
        ctx["G"] = copy.deepcopy(state.G_ema).eval().requires_grad_(False)
    gen = ctx["G"]
    gen.load_state_dict(state.G_ema.state_dict())
    fid_value = None
    for name in ctx["metrics"]:
        if not metric_main.is_valid_metric(name):
            print_log(f"unknown metric {name!r}")
            continue
        result = metric_main.calc_metric(
            name, dataset=ctx["dataset"],
            generator_fn=lambda x: generator_apply(gen, x,
                                                   noise_mode="const"),
            detector_fn=ctx["detector"], detector_tag=ctx["detector_tag"],
            batch_size=ctx["batch_size"], max_items=ctx["max_items"],
            cache_dir=osp.join(log_dir, "fid-cache"),
            dataset_tag=ctx["dataset_tag"], device=ctx["device"])
        metric_main.report_metric(result, run_dir=log_dir)
        if fid_value is None:
            fid_value = result["results"].get("fid")
    return fid_value


def _stage(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on `device`: on a card by one copy from pinned memory
    that does not wait for the device's queue."""
    t = torch.from_numpy(arr)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _report_calls(calls: list) -> None:
    """Reports the calls' stats (a fused call's stacked rows, or one
    step's row of `full_stats`) row by row, in step order, each averaged
    over the ranks (`stacked_mean_across_ranks`), without R1's keys where
    R1 did not run (`migan_tpu/train/loop.py:397-409`)."""
    if not calls:
        return
    host = training_stats.stacked_mean_across_ranks(calls)
    r1_ran = host.pop(R1_RAN)
    for i, ran in enumerate(r1_ran):
        row = {k: v[i] for k, v in host.items()
               if ran >= 0.5 or k not in R1_KEYS}
        training_stats._default_registry.report_dict(row)
    calls.clear()


def step_seed(seed: int, step: int) -> int:
    """The seed of the noise generator of absolute step `step`."""
    return int(np.random.SeedSequence([seed, 0x5EED, step]).generate_state(
        1, np.uint64)[0])


def train_stage(cfg: Dict[str, Any], max_steps: Optional[int] = None,
                device="cuda") -> TrainState:
    """Run training from a resolved experiment config dict on `device`;
    returns the final state."""
    from ..data.factory import get_dataset
    from ..data.sampler import DataLoader, InfiniteSampler
    from ..models.registry import count_params, get_model

    device = torch.device(device)
    print_log(parallel.describe(device))
    cfgt = cfg["train"]
    log_dir = cfgt["log_dir"]
    os.makedirs(log_dir, exist_ok=True)
    seed = cfg.get("env", {}).get("rnd_seed", 0)
    np.random.seed(seed)
    n_proc, proc = parallel.world(), parallel.rank()
    is_chief = proc == 0

    # ----- data ------------------------------------------------------------
    trainset = get_dataset(cfgt["dataset"])
    print_log(f"train dataset: {cfgt['dataset']['name']} "
              f"({len(trainset)} items)")
    batch_size = cfgt["batch_size"]
    tcfg = _train_config_from_cfg(cfgt)
    rounds = max(1, tcfg.grad_accum_rounds)
    if batch_size % (n_proc * rounds):
        raise ValueError(f"batch_size {batch_size} not divisible by "
                         f"{n_proc} ranks x {rounds} rounds")
    local_bs = batch_size // n_proc
    # rank p's round r is rows [p*block, (p+1)*block) of the global round r
    block = local_bs // rounds
    sampler = InfiniteSampler(len(trainset), num_shards=n_proc, shard=proc,
                              seed=seed, block=block)

    # ----- models ----------------------------------------------------------
    g_cfg = get_model()(cfg["model_g"]).cfg
    d_cfg = get_model()(cfg["model_d"]).cfg
    teacher = _make_teacher(cfgt, device)
    state = init_train_state(torch.Generator().manual_seed(seed), g_cfg,
                             d_cfg, tcfg, device)
    print_log(f"G params: {count_params(state.G):,}  "
              f"D params: {count_params(state.D):,}")

    resume_path = cfgt.get("resume_path")
    if resume_path:
        path = ckpt.latest(resume_path) or resume_path
        state = ckpt.restore(path, state)
        print_log(f"resumed from {path} at step {state.step}")

    # the data stream is addressed by absolute item position: skip the
    # items the restored steps consumed; this rank's items sit at their
    # single-process positions
    skip_items = state.step * local_bs
    sampler_it = iter(sampler)
    if skip_items:
        next(itertools.islice(sampler_it, skip_items - 1, skip_items))
    loader = DataLoader(trainset, local_bs, indices=sampler_it,
                        num_workers=cfgt.get("dataset_num_workers") or 4,
                        seed=seed,
                        start_position=state.step * batch_size
                        + proc * block,
                        position_stride=n_proc, position_block=block)
    spc = int(cfgt.get("steps_per_call") or 1)
    if spc > 1:
        fused_fn = make_fused_train_step(g_cfg, d_cfg, tcfg, teacher=teacher,
                                         steps_per_call=spc, device=device)
    else:
        step_fn = make_train_step(g_cfg, d_cfg, tcfg, teacher=teacher)
    d_reg_interval = cfgt.get("d_reg_interval") or 0
    wire = cfgt.get("wire_format") or "f32"
    if wire not in ("f32", "u8"):
        raise ValueError(f"train.wire_format must be f32|u8, got {wire!r}")

    # ----- loop ------------------------------------------------------------
    total_kimg = cfgt.get("total_kimg", 25000)
    kimg_per_tick = cfgt.get("kimg_per_tick", 4)
    snapshot = cfgt.get("snapshot", {})
    collector = training_stats.default_collector()
    tb = _make_tb_writer(log_dir) if is_chief else None
    cur_nimg = state.nimg
    batch_idx = state.step
    cur_tick = 0
    tick_start_nimg = cur_nimg
    tick_start_time = time.time()
    start_time = tick_start_time
    best_metric = None
    metric_ctx = _build_metric_ctx(cfg, device)
    ckpt_dir = osp.join(log_dir, "weight")
    drew_init = not is_chief
    done = False
    step_buf: list = []       # buffered (real, mask) host batches (spc > 1)
    pending_stats: list = []  # the calls' stats, on the device
    stats_path = osp.join(log_dir, "stats.jsonl") if is_chief else os.devnull
    with open(stats_path, "at") as stats_jsonl:
        for x, mask, _uid in loader:
            if not drew_init:
                # init grids (reference draw_functor isinit branch,
                # migan_default.py:99-129)
                drew_init = True
                m = mask[..., None]
                _save_image_grid(x, osp.join(log_dir, "reals.png"))
                _save_image_grid(m * 2 - 1, osp.join(log_dir, "masks.png"))
                _save_image_grid(x * m, osp.join(log_dir, "erased.png"))
            xw, mw = _encode_wire(np.asarray(x), np.asarray(mask[..., None]),
                                  wire)
            if spc > 1:
                step_buf.append((xw, mw))
                if len(step_buf) < spc:
                    continue
                batch = {
                    "real": _stage(np.stack([r for r, _ in step_buf]),
                                   device),
                    "mask": _stage(np.stack([m for _, m in step_buf]),
                                   device)}
                # the buffered steps' absolute indices seed their noise
                seeds = [step_seed(seed, batch_idx + i) for i in range(spc)]
                pending_stats.append(fused_fn(state, batch, seeds))
                step_buf.clear()
                cur_nimg += batch_size * spc
                batch_idx += spc
            else:
                batch = {"real": torch.from_numpy(xw).to(device),
                         "mask": torch.from_numpy(mw).to(device)}
                gen = torch.Generator(device).manual_seed(
                    step_seed(seed, batch_idx))
                do_dr1 = (d_reg_interval > 0
                          and batch_idx % d_reg_interval == 0)
                pending_stats.append(full_stats(
                    step_fn(state, batch, gen, do_dr1=do_dr1), do_dr1,
                    device))
                cur_nimg += batch_size
                batch_idx += 1
            done = (cur_nimg >= total_kimg * 1000
                    or (max_steps is not None and batch_idx >= max_steps))
            if not done and cur_nimg < (tick_start_nimg
                                        + kimg_per_tick * 1000):
                continue

            # ---- tick maintenance (reference migan_default.py:429-585) ---
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            _report_calls(pending_stats)
            tick_time = time.time() - tick_start_time
            collector.update()
            resources = _resource_stats(device)
            fields = {
                "tick": cur_tick,
                "kimg": round(cur_nimg / 1000.0, 1),
                "time_sec": round(time.time() - start_time, 1),
                "sec_per_kimg": round(
                    tick_time / max(cur_nimg - tick_start_nimg, 1) * 1000,
                    2),
            }
            line = "  ".join(f"{k} {v}" for k, v in fields.items())
            loss_keys = [k for k in collector.names()
                         if k.startswith("Loss/")]
            line += "  " + "  ".join(
                f"{k.split('/', 1)[1]} {collector.mean(k):.3f}"
                for k in sorted(loss_keys)[:6])
            if "Resources/cpu_mem_gb" in resources:
                line += f"  cpumem {resources['Resources/cpu_mem_gb']:.2f}g"
            if "Resources/peak_device_mem_gb" in resources:
                line += (f"  devmem "
                         f"{resources['Resources/peak_device_mem_gb']:.2f}g")
            if is_chief:
                print_log(line)
            stats_jsonl.write(json.dumps(
                {**fields, **collector.as_dict(), **resources}) + "\n")
            stats_jsonl.flush()
            if tb is not None:
                for k in collector.names():
                    tb.add_scalar(k, collector.mean(k), cur_nimg)
                for k, v in resources.items():
                    tb.add_scalar(k, v, cur_nimg)
                tb.flush()

            if (is_chief and snapshot.get("image")
                    and cur_tick % snapshot["image"] == 0):
                from ..models.migan import generator_apply

                m = np.asarray(mask[..., None])
                real = np.asarray(x)
                with torch.no_grad():
                    demo = generator_apply(
                        state.G_ema, torch.from_numpy(np.concatenate(
                            [m - 0.5, real * m], axis=-1)).to(device),
                        noise_mode="const").float().cpu().numpy()
                tag = f"{cur_nimg // 1000:06d}"
                _save_image_grid(demo, osp.join(log_dir, f"fakes{tag}.png"))
                # composited sheet: known pixels real, the hole generated
                _save_image_grid(real * m + demo * (1 - m), osp.join(
                    log_dir, f"fakes{tag}_combined.png"))

            if (snapshot.get("evaluate") and metric_ctx is not None
                    and cur_tick % snapshot["evaluate"] == 0
                    and cur_tick > 0):
                fid = parallel.broadcast_scalar(
                    _run_metrics(state, metric_ctx, log_dir) if is_chief
                    else None)
                if fid is not None and is_chief:
                    print_log(f"tick {cur_tick}  Metrics/fid {fid:.3f}")
                    stats_jsonl.write(json.dumps(
                        {"tick": cur_tick, "kimg": round(cur_nimg / 1e3, 1),
                         "Metrics/fid": fid}) + "\n")
                    stats_jsonl.flush()
                    if tb is not None:
                        tb.add_scalar("Metrics/fid", fid, cur_nimg)
                if fid is not None and (best_metric is None
                                        or fid < best_metric):
                    # the reference keeps one best snapshot, the lowest
                    # FID (migan_default.py:139-146)
                    best_metric = fid
                    if is_chief:
                        best_dir = osp.join(ckpt_dir, "best")
                        path = ckpt.save(best_dir, batch_idx, state)
                        for d in os.listdir(best_dir):
                            if (d.startswith("step_")
                                    and d != osp.basename(path)):
                                shutil.rmtree(osp.join(best_dir, d))
                        print_log(f"new best FID {fid:.3f}: {path}")
                    parallel.barrier()

            if snapshot.get("checkpoint") and (
                    cur_tick % snapshot["checkpoint"] == 0 or done):
                if is_chief:
                    path = ckpt.save(ckpt_dir, batch_idx, state)
                    print_log(f"checkpoint: {path}")
                parallel.barrier()

            cur_tick += 1
            tick_start_nimg = cur_nimg
            tick_start_time = time.time()
            if done:
                break
    if tb is not None:
        tb.close()
    return state
