"""The port's data-parallel train step and discriminator on 2 gloo ranks
(`tests/test_torch_parallel_worker.py`) on the CPU.

  - One full step (Gmain with KD, Dmain, Dreg, EMA) of the nets and batch
    of `test_torch_train_step.py::test_full_step_matches_jax` in float64,
    batch 4, 2 rows a rank: each phase's all-reduced gradient within
    1e-9 relative L2 of the one-process port step from the same
    `torch.Generator` seed (float64 sums in another order); also with 2
    rounds of gradient accumulation, where rank p holds row p of each
    global round, as the training loop lays the rows out; the ranks'
    mean stats within 1e-6 relative of that step's (the losses on the
    logits are float32, `train/loss.py`). The control swaps
    in a per-rank minibatch-std (the reference's DDP statistic): its
    gradients miss by more than 1e-3, so the bound sees the statistic.
  - D's logits of a global batch of 8, 4 rows a rank, equal the JAX
    package's `discriminator_apply` on the whole batch, where
    minibatch-std groups rows of both ranks (NET_RTOL / NET_ATOL of
    `test_torch_train_nets.py`).
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from migan_tpu.models import migan as jm
from migan_tpu_torch.models import comodgan as tc
from migan_tpu_torch.train import loss as tl
from migan_tpu_torch.train import train_step as tts
from test_torch_train_nets import NET_ATOL, NET_RTOL
from test_torch_train_step import KD, _batch, _nets, _teacher
from test_torch_parallel_worker import launch

@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The gate runs 6 test workers on one host: torch's default of one
    thread per core in each of them oversubscribes it several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


STEP_RTOL = 1e-9
CONTROL_MISS = 1e-3
EMA = dict(batch_size=4, ema_kimg=0.004, ema_rampup=None)
SEED = 11


def _rel_l2(a, b) -> float:
    a = torch.cat([t.flatten() for t in a])
    b = torch.cat([t.flatten() for t in b])
    return float((a - b).norm() / b.norm())


def _one_process_step(inp, rounds):
    """The one-process port step's gradients per phase and stats."""
    applied = []
    orig = tts._apply

    def spy(opt, params, grads):
        applied.append([g.clone() for g in grads])
        orig(opt, params, grads)

    cfg = tts.TrainConfig(**EMA, loss=tl.LossConfig(kd=tl.KDConfig(**KD)),
                          grad_accum_rounds=rounds)
    state = tts.state_from_modules(copy.deepcopy(inp["G"]),
                                   copy.deepcopy(inp["D"]), cfg)
    teacher = inp["teacher"]
    step = tts.make_train_step(
        state.G.cfg, state.D.cfg, cfg,
        teacher=(tc.make_teacher_apply(teacher.cfg), teacher))
    tts._apply = spy
    try:
        stats = step(state, {"real": inp["real"], "mask": inp["mask"]},
                     torch.Generator().manual_seed(SEED), do_dr1=True)
    finally:
        tts._apply = orig
    return applied, {k: float(v) for k, v in stats.items()}


@pytest.fixture(scope="module")
def step_inputs(tmp_path_factory):
    """The float64 nets, teacher and batch, and the one-process step's
    results by rounds (made at first use)."""
    _, _, _, G, D = _nets(6)
    _, (_, teacher) = _teacher(7)
    G, D, teacher = G.double(), D.double(), teacher.double()
    real, mask = (torch.from_numpy(a.astype(np.float64))
                  for a in _batch(seed=8))
    inp = {"G": G, "D": D, "teacher": teacher, "real": real, "mask": mask,
           "ema": EMA, "kd": KD, "seed": SEED}
    wants = {}

    def want(rounds):
        if rounds not in wants:
            wants[rounds] = _one_process_step(inp, rounds)
        return wants[rounds]

    return tmp_path_factory.mktemp("step"), inp, want


@pytest.mark.parametrize("local_mbstd,rounds", [(False, 1), (True, 1),
                                                (False, 2)])
def test_two_rank_step_matches_one_process(step_inputs, local_mbstd,
                                           rounds):
    root, inp, want = step_inputs
    want, want_stats = want(rounds)
    # rank p's round r: rows [p*b, (p+1)*b) of the global round r
    size = 4 // rounds
    b = size // 2
    order = [r * size + p * b + j for p in range(2) for r in range(rounds)
             for j in range(b)]
    inp = dict(inp, local_mbstd=local_mbstd, rounds=rounds,
               real=inp["real"][order], mask=inp["mask"][order])
    tag = f"{local_mbstd}_{rounds}"
    torch.save(inp, root / f"in_{tag}.pt")
    out = str(root / f"out_{tag}")
    launch("step", str(root / f"in_{tag}.pt"), out)
    ranks = [torch.load(f"{out}.{r}", weights_only=False) for r in range(2)]
    for got in ranks[1:]:         # the ranks apply the same gradients
        for a, b in zip(got["grads"], ranks[0]["grads"]):
            assert all(torch.equal(x, y) for x, y in zip(a, b))
    got = ranks[0]
    assert len(got["grads"]) == 3 and got["nimg"] == 4
    errs = {phase: _rel_l2(g, w) for phase, g, w in
            zip(("Gmain", "Dmain", "Dreg"), got["grads"], want)}
    print(f"local_mbstd={local_mbstd}: gradient relative L2 {errs}")
    if local_mbstd:
        assert max(errs.values()) > CONTROL_MISS, errs
        return
    assert max(errs.values()) <= STEP_RTOL, errs
    assert set(got["stats"]) == set(want_stats)
    for k, v in want_stats.items():
        np.testing.assert_allclose(got["stats"][k], v, rtol=1e-6,
                                   atol=1e-12, err_msg=k)


def test_two_rank_discriminator_matches_jax(tmp_path):
    jcfg, _, pd, _, D = _nets(6)
    real, mask = _batch(n=8, seed=9)
    x = np.concatenate([mask - 0.5, real], axis=-1)
    want = np.asarray(jm.discriminator_apply(pd, jnp.asarray(x), jcfg))
    torch.save({"D": D, "x": torch.from_numpy(x)}, tmp_path / "in.pt")
    out = str(tmp_path / "out")
    launch("d", str(tmp_path / "in.pt"), out)
    got = torch.cat([torch.load(f"{out}.{r}") for r in range(2)]).numpy()
    np.testing.assert_allclose(got, want, rtol=NET_RTOL, atol=NET_ATOL)
    # the per-rank statistic gives logits outside the bound
    with torch.no_grad():
        local = torch.cat([D(torch.from_numpy(x[4 * r:4 * r + 4]))
                           for r in range(2)]).numpy()
    assert not np.allclose(local, want, rtol=NET_RTOL, atol=NET_ATOL)
