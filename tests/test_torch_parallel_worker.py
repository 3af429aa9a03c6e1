"""One rank of the port's data-parallel tests
(`tests/test_torch_parallel_*.py`).

`launch(role, inp, out, nproc)` starts `nproc` processes of this file on
the CPU, each with the env `torch.distributed.run` would give it
(`WORLD_SIZE`, `RANK`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`: a free
localhost port), one thread each and its own timeout; each joins a
gloo group through `parallel.maybe_initialize_distributed` and runs
`role`:

  - step: one train step (Gmain with KD, Dmain, Dreg, EMA) of the nets in
    `inp` on this rank's rows of the batch (`inp`'s rows in rank order),
    with `rounds` of gradient accumulation; saves each phase's
    all-reduced gradients (as `_apply` receives them) and the ranks' mean
    stats. `local_mbstd` swaps in a per-rank minibatch-std (the
    reference's DDP statistic), the control.
  - fused: `fused_calls`, the fused k-step calls of the nets in `inp`
    on this rank's rows of each step's batch; saves the final state and
    the ranks' mean stacked stats.
  - d: the discriminator's logits of this rank's rows.
  - train: `train_stage` of a config, 3 steps; saves the final state.
  - evaluate: the evaluate CLI; rank 0 saves the per-item results.
  - spatial: `generator_apply_spatial` of each case of `inp` (a
    generator, a global input) on this rank's rows (`shard_rows`, held
    against `gather_rows`' inverse); saves this rank's output rows per
    case. A case with `local_noise` makes the noise at the rank's own
    height, the control. A case whose input the forward refuses saves
    the `ValueError`'s message instead.

This file imports only the port (and torch, numpy).
"""

import json
import os
import socket
import subprocess
import sys

import torch

from migan_tpu_torch import parallel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300


def launch(role: str, inp: str, out: str, nproc: int = 2) -> list:
    """Runs the ranks; returns each rank's output. Fails (with the logs)
    on a non-zero exit or a rank that outlives TIMEOUT seconds."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(nproc):
        # one thread per rank, BLAS included (the FID's matrix square
        # root): the gate runs several test workers on one host
        env = dict(os.environ, WORLD_SIZE=str(nproc), RANK=str(r),
                   LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), PYTHONPATH=REPO,
                   OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, __file__, role, inp, out], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"{role} rank {r}: exit {p.returncode}\n" \
            f"{log[-4000:]}"
    return logs


def _local_minibatch_std(x, group_size, num_channels=1):
    """The per-rank statistic: groups within this rank's rows only."""
    n, h, w, c = x.shape
    g = min(group_size, n)
    y = x.reshape(g, n // g, h, w, num_channels, c // num_channels)
    y = y - y.mean(dim=0)
    y = (y.square().mean(dim=0) + 1e-8).sqrt()
    y = y.mean(dim=(1, 2, 4)).reshape(-1, 1, 1, num_channels)
    return torch.cat([x, y.repeat(g, h, w, 1).to(x.dtype)], dim=-1)


def _rows(t):
    n = t.shape[0] // parallel.world()
    return t[parallel.rank() * n:(parallel.rank() + 1) * n]


def step(inp, out):
    from migan_tpu_torch.models import comodgan, migan
    from migan_tpu_torch.train import loss, train_step
    from migan_tpu_torch.utils.stats import stacked_mean_across_ranks

    a = torch.load(inp, weights_only=False)
    if a["local_mbstd"]:
        migan.minibatch_std = _local_minibatch_std
    cfg = train_step.TrainConfig(
        **a["ema"], loss=loss.LossConfig(kd=loss.KDConfig(**a["kd"])),
        grad_accum_rounds=a["rounds"])
    G, D, teacher = a["G"], a["D"], a["teacher"]
    applied = []
    orig = train_step._apply

    def spy(opt, params, grads):
        applied.append([g.clone() for g in grads])
        orig(opt, params, grads)

    train_step._apply = spy
    state = train_step.state_from_modules(G, D, cfg)
    fn = train_step.make_train_step(
        G.cfg, D.cfg, cfg,
        teacher=(comodgan.make_teacher_apply(teacher.cfg), teacher))
    stats = fn(state, {"real": _rows(a["real"]), "mask": _rows(a["mask"])},
               torch.Generator().manual_seed(a["seed"]), do_dr1=True)
    stats = {k: float(v[0])
             for k, v in stacked_mean_across_ranks([stats]).items()}
    torch.save({"grads": applied, "stats": stats, "nimg": state.nimg},
               f"{out}.{parallel.rank()}")


def fused_calls(a):
    """(final state dict, stats) of the fused calls of `a` ("k" steps a
    call from step "start", R1 every "interval" steps, KD) on this
    rank's rows of each of "batches" with "seeds", on the CPU; the stats
    are the calls' stacked stats, the ranks' means."""
    from migan_tpu_torch.models import comodgan
    from migan_tpu_torch.train import loss, train_step
    from migan_tpu_torch.utils.stats import stacked_mean_across_ranks

    cfg = train_step.TrainConfig(
        **a["ema"], d_opt=train_step.OptConfig(reg_interval=a["interval"]),
        loss=loss.LossConfig(kd=loss.KDConfig(**a["kd"])))
    G, D, teacher = a["G"], a["D"], a["teacher"]
    state = train_step.state_from_modules(G, D, cfg)
    state.step = a["start"]
    fused = train_step.make_fused_train_step(
        G.cfg, D.cfg, cfg,
        teacher=(comodgan.make_teacher_apply(teacher.cfg), teacher),
        steps_per_call=a["k"], device="cpu")
    k, calls = a["k"], []
    for c in range(len(a["batches"]) // k):
        part = a["batches"][c * k:(c + 1) * k]
        calls.append(fused(state, {
            "real": torch.stack([_rows(r) for r, _ in part]),
            "mask": torch.stack([_rows(m) for _, m in part])},
            a["seeds"][c * k:(c + 1) * k]))
    return state.state_dict(), stacked_mean_across_ranks(calls)


def fused(inp, out):
    state, stats = fused_calls(torch.load(inp, weights_only=False))
    torch.save({"state": state, "stats": stats}, f"{out}.{parallel.rank()}")


def d(inp, out):
    a = torch.load(inp, weights_only=False)
    with torch.no_grad():
        logits = a["D"](_rows(a["x"]))
    torch.save(logits, f"{out}.{parallel.rank()}")


def train(inp, out):
    from migan_tpu_torch.train.loop import train_stage

    with open(inp) as f:
        cfg = json.load(f)
    state = train_stage(cfg, max_steps=3, device="cpu")
    torch.save(state.state_dict(), f"{out}.{parallel.rank()}")


def evaluate(inp, out):
    import numpy as np

    from migan_tpu_torch.cli import evaluate

    with open(inp) as f:
        argv = json.load(f)
    details = {}
    fid, lp = evaluate.main(argv, details=details)
    if os.environ["RANK"] == "0":
        np.savez(out, fid=fid, lpips=details["lpips"],
                 real_acts=details["real_acts"],
                 fake_acts=details["fake_acts"])


def spatial(inp, out):
    from migan_tpu_torch.models import migan_inference as mi
    from migan_tpu_torch.parallel import spatial as sp

    a = torch.load(inp, weights_only=False)
    got = {}
    orig = sp.RowStencils.noise
    for case in a["cases"]:
        g = a["generators"][case["generator"]]
        x = case["x"].to(next(g.parameters()).dtype)
        x_local = sp.shard_rows(x)
        assert x_local.shape[1] == x.shape[1] // parallel.world()
        assert torch.equal(sp.gather_rows(x_local), x)
        if case.get("local_noise"):
            sp.RowStencils.noise = mi.Stencils.noise   # local height
        try:
            got[case["name"]] = sp.generator_apply_spatial(g, x_local)
        except ValueError as e:
            got[case["name"]] = str(e)
        finally:
            sp.RowStencils.noise = orig
    torch.save(got, f"{out}.{parallel.rank()}")


if __name__ == "__main__":
    torch.set_num_threads(1)
    role, inp, out = sys.argv[1:4]
    if role == "evaluate":          # the CLI joins the group itself
        evaluate(inp, out)
    else:
        parallel.maybe_initialize_distributed("cpu")
        try:
            {"step": step, "fused": fused, "d": d,
             "train": train, "spatial": spatial}[role](inp, out)
        finally:
            parallel.destroy()
