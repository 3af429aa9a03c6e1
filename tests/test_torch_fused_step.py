"""The port's fused k-step training call (`train_step.FusedTrainStep`,
`make_fused_train_step`) on the CPU, where it runs its steps eagerly.

  - At k = 2 and 3, over two calls that start at step 2 with R1 every 3
    steps (so R1 falls inside a call), it is bit-equal to k sequential
    `TrainStep` calls with the loop's seeds and R1 schedule: G, D, the
    EMA, both Adam states, step and nimg, and its stacked stats equal the
    sequential steps' stats, with R1's keys zero and `Misc/r1_ran` 0
    where R1 did not run (tolerance: none).
  - It matches the JAX package's `make_fused_train_step` at k = 2 (steps
    2 and 3, R1 at 3 through `lax.cond`), Gmain with KD, in float64 as
    `test_torch_train_step.py::test_full_step_matches_jax` runs: the same
    numpy-seeded noise is fed to both sides (`_Noise`'s patches; the JAX
    scan traces its body once, so every step of it draws the first step's
    noise, and the port's patch replays that noise at every step): each
    step's stats within LOSS_RTOL (1e-5) relative, `Misc/r1_ran` exact,
    every parameter of G, D and the EMA within GRAD_RTOL (1e-4) relative
    L2.
  - A capturable Adam's state dict (the card's) loads into the CPU's
    Adam and takes the same next update (`load_adam`; tolerance: none).
  - On 2 gloo ranks (`test_torch_parallel_worker.py`, 2 rows a rank) the
    fused call in float64 gives the one-process fused call's state within
    1e-9 relative L2 per module and its stats (the ranks' means) within
    1e-6 relative (the parallel step test's bounds).
  - The loop's `train.steps_per_call` k > 1 (`train/loop.py`), mirroring
    `tests/test_train_loop.py::test_train_stage_steps_per_call`: at k = 2
    the final state is bit-equal to k = 1's, stats.jsonl has the same
    records, keys and loss moments, R1's keys only in the ticks whose
    steps ran R1; a fused checkpoint resumed sequentially and a
    sequential one resumed fused reach the uninterrupted state bit for
    bit.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from migan_tpu.io import checkpoint as jckpt
from migan_tpu.train import loss as jl
from migan_tpu.train import train_step as jts
from migan_tpu_torch.io.train_weights import state_to_params
from migan_tpu_torch.models import comodgan as tc
from migan_tpu_torch.train import loop
from migan_tpu_torch.train import loss as tl
from migan_tpu_torch.train import train_step as tts
from test_torch_parallel_worker import launch
from test_torch_train_loop import _equal
from test_torch_train_loop import smoke_cfg  # noqa: F401  (fixture)
from test_torch_train_step import (GRAD_RTOL, KD, LOSS_RTOL, _batch, _nets,
                                   _Noise, _teacher)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The gate runs 6 test workers on one host: torch's default of one
    thread per core in each of them oversubscribes it several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


START, INTERVAL, SEED = 2, 3, 0
EMA = dict(batch_size=2, ema_kimg=0.004, ema_rampup=None)


def _cfg(rounds=1):
    return tts.TrainConfig(
        **EMA, d_opt=tts.OptConfig(reg_interval=INTERVAL),
        loss=tl.LossConfig(kd=tl.KDConfig(**KD)), grad_accum_rounds=rounds)


def _setup(seed=6, dtype=torch.float32):
    """(state at step START, step, teacher module): the 8 px nets of
    test_torch_train_step.py and its KD teacher."""
    _, _, _, G, D = _nets(seed)
    _, (_, teacher) = _teacher(seed + 1)
    G, D, teacher = G.to(dtype), D.to(dtype), teacher.to(dtype)
    cfg = _cfg()
    state = tts.state_from_modules(G, D, cfg)
    state.step = START
    step = tts.make_train_step(
        G.cfg, D.cfg, cfg,
        teacher=(tc.make_teacher_apply(teacher.cfg), teacher))
    return state, step


def _batches(n_steps, dtype=np.float32):
    return [tuple(a.astype(dtype) for a in _batch(n=2, seed=20 + i))
            for i in range(n_steps)]


@pytest.mark.parametrize("k", [2, 3])
def test_fused_equals_sequential_steps(k):
    state_a, step = _setup()
    state_b = copy.deepcopy(state_a)
    batches = _batches(2 * k)
    seeds = [loop.step_seed(SEED, START + i) for i in range(2 * k)]
    rows = []
    for i, (real, mask) in enumerate(batches):
        do = state_a.step % INTERVAL == 0
        stats = step(state_a, {"real": torch.from_numpy(real),
                               "mask": torch.from_numpy(mask)},
                     torch.Generator().manual_seed(seeds[i]), do_dr1=do)
        rows.append((stats, do))

    fused = tts.FusedTrainStep(step, k, "cpu")
    got = []
    for c in range(2):
        part = batches[c * k:(c + 1) * k]
        got.append(fused(state_b, {
            "real": torch.from_numpy(np.stack([r for r, _ in part])),
            "mask": torch.from_numpy(np.stack([m for _, m in part]))},
            seeds[c * k:(c + 1) * k]))
    _equal(state_b.state_dict(), state_a.state_dict())
    assert state_b.step == START + 2 * k and state_b.nimg == 4 * k
    ran = [float(do) for _, do in rows]
    assert sum(ran) >= 1 and ran[0] == 0      # R1 inside a call
    stacked = {key: torch.cat([g[key] for g in got]) for key in got[0]}
    assert stacked[tts.R1_RAN].tolist() == ran
    assert list(stacked) == list(rows[ran.index(1)][0]) + [tts.R1_RAN]
    for i, (stats, do) in enumerate(rows):
        for key in tts.R1_KEYS:
            assert (key in stats) == do
        for key, col in stacked.items():
            want = stats.get(key, torch.zeros(()))
            if key == tts.R1_RAN:
                want = torch.tensor(float(do))
            assert torch.equal(col[i], want.float()), (i, key)


def test_fused_rejects_a_call_of_another_length():
    state, step = _setup()
    real, mask = _batches(1)[0]
    fused = tts.FusedTrainStep(step, 2, "cpu")
    with pytest.raises(ValueError, match="takes 2 steps"):
        fused(state, {"real": torch.from_numpy(real[None]),
                      "mask": torch.from_numpy(mask[None])}, [0])


def test_adam_state_loads_with_the_optimizers_own_capturable():
    """A state dict written by a capturable Adam (the card's) loads into
    the CPU's Adam as a CPU state (`load_adam`): capturable stays off,
    the step count is a CPU float32 tensor, and the next update equals
    the writer's own next update (tolerance: none)."""
    rng = np.random.RandomState(0)
    p0 = torch.from_numpy(rng.randn(5, 7).astype(np.float32))
    g1, g2 = (torch.from_numpy(rng.randn(5, 7).astype(np.float32))
              for _ in range(2))
    opt_cfg = tts.OptConfig(reg_interval=16, beta1=0.0)
    p = torch.nn.Parameter(p0.clone())
    adam = tts.make_optimizer([p], opt_cfg)
    assert adam.defaults["capturable"] is False
    p.grad = g1
    adam.step()
    sd = copy.deepcopy(adam.state_dict())
    sd["param_groups"][0]["capturable"] = True    # as a card writes it
    q = torch.nn.Parameter(p.detach().clone())
    other = tts.make_optimizer([q], opt_cfg)
    tts.load_adam(other, sd)
    assert other.param_groups[0]["capturable"] is False
    step = other.state[q]["step"]
    assert step.device.type == "cpu" and step.dtype == torch.float32
    p.grad, q.grad = g2, g2.clone()
    adam.step()
    other.step()
    assert torch.equal(q, p)


class _ReplayedNoise(_Noise):
    """`_Noise` with the JAX scan's semantics: the port's first step draws
    the numpy-seeded noise (its `torch.randn` patched), every later step
    replays it in the same order (shapes checked); JAX's
    `jax.random.normal`, traced once in the scan's body, returns it once
    in that order (`_Noise.jax`)."""

    def port(self):
        self.step, self.pos = -1, 0
        orig_call = tts.TrainStep.__call__

        def call(step, *a, **kw):
            self.step, self.pos = self.step + 1, 0
            return orig_call(step, *a, **kw)

        def fake(*shape, generator=None, device=None, dtype=None, **kw):
            if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
                shape = tuple(shape[0])
            if self.step == 0:
                a = self.rng.randn(*shape).astype(np.float32)
                self.draws.append(a)
            else:
                a = self.draws[self.pos]
                assert a.shape == tuple(shape), (a.shape, shape)
                self.pos += 1
            return torch.from_numpy(a.copy()).to(device=device,
                                                 dtype=dtype or torch.float32)

        self.mp.setattr(tts.TrainStep, "__call__", call)
        self.mp.setattr(torch, "randn", fake)


def _rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def test_fused_matches_jax_fused_program(monkeypatch):
    f64 = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: jnp.asarray(a, jnp.float64), t)
    k = 2
    jcfg, pg, pd, G, D = _nets(6)
    (j_apply, j_tparams), (_, teacher) = _teacher(7)
    G, D, teacher = G.double(), D.double(), teacher.double()
    batches = _batches(k, np.float64)
    real = np.stack([r for r, _ in batches])
    mask = np.stack([m for _, m in batches])
    cfg_t = _cfg()
    cfg_j = jts.TrainConfig(**EMA, d_opt=jts.OptConfig(reg_interval=INTERVAL),
                            loss=jl.LossConfig(kd=jl.KDConfig(**KD)))
    noise = _ReplayedNoise(monkeypatch, 11)
    noise.port()
    state = tts.state_from_modules(G, D, cfg_t)
    state.step = START
    fused = tts.make_fused_train_step(
        G.cfg, D.cfg, cfg_t,
        teacher=(tc.make_teacher_apply(teacher.cfg), teacher),
        steps_per_call=k, device="cpu")
    stats = fused(state, {"real": torch.from_numpy(real),
                          "mask": torch.from_numpy(mask)}, [1, 2])
    assert noise.step == k - 1 and noise.pos == len(noise.draws)

    it = noise.jax()
    with jax.enable_x64(True):
        pg, pd, j_tparams = f64(pg), f64(pd), f64(j_tparams)
        jstate = jts.TrainState(
            params_G=pg, params_D=pd,
            params_G_ema=jax.tree_util.tree_map(jnp.copy, pg),
            opt_G=jts.make_optimizer(cfg_j.g_opt).init(pg),
            opt_D=jts.make_optimizer(cfg_j.d_opt).init(pd),
            step=jnp.asarray(START, jnp.int32),
            nimg=jnp.zeros((), jnp.int32))
        jfused = jts.make_fused_train_step(
            jcfg, jcfg, cfg_j, teacher_fn=(j_apply, j_tparams),
            steps_per_call=k)
        jnew, want = jfused(jstate, {"real": jnp.asarray(real),
                                     "mask": jnp.asarray(mask)},
                            jax.random.split(jax.random.PRNGKey(11), k))
        want = jax.tree_util.tree_map(np.asarray, want)
        new = {name: jax.tree_util.tree_map(np.asarray, getattr(jnew, name))
               for name in ("params_G", "params_D", "params_G_ema")}
    assert next(it, None) is None                  # every draw consumed
    assert int(jnew.step) == state.step == START + k
    assert int(jnew.nimg) == state.nimg == 2 * k

    assert set(stats) == set(want)
    np.testing.assert_array_equal(stats[tts.R1_RAN].numpy(),
                                  want[tts.R1_RAN])
    assert want[tts.R1_RAN].tolist() == [0.0, 1.0]
    for key, v in want.items():
        np.testing.assert_allclose(stats[key].numpy(), v, rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=key)
    for name, module in (("params_G", state.G), ("params_D", state.D),
                         ("params_G_ema", state.G_ema)):
        got = state_to_params(module.state_dict())
        ref = jckpt._flatten(new[name])
        assert set(got) <= set(ref)
        for key, g in got.items():
            assert _rel_l2(g, ref[key]) <= GRAD_RTOL, (name, key)


def test_two_rank_fused_matches_one_process(tmp_path):
    """2 calls of k = 2 from step START, batch 4 (2 rows a rank)."""
    k = 2
    _, _, _, G, D = _nets(6)
    _, (_, teacher) = _teacher(7)
    G, D, teacher = G.double(), D.double(), teacher.double()
    batches = [tuple(torch.from_numpy(a.astype(np.float64))
                     for a in _batch(n=4, seed=30 + i)) for i in range(2 * k)]
    seeds = [loop.step_seed(SEED, START + i) for i in range(2 * k)]
    inp = {"G": G, "D": D, "teacher": teacher, "batches": batches,
           "seeds": seeds, "k": k, "start": START, "interval": INTERVAL,
           "ema": dict(EMA, batch_size=4), "kd": KD}
    torch.save(inp, tmp_path / "in.pt")
    out = str(tmp_path / "out")
    launch("fused", str(tmp_path / "in.pt"), out)
    ranks = [torch.load(f"{out}.{r}", weights_only=False) for r in range(2)]
    # the one-process fused calls
    from test_torch_parallel_worker import fused_calls

    want_state, want_stats = fused_calls(copy.deepcopy(inp))
    for got in ranks:
        for name in ("params_G", "params_D", "params_G_ema"):
            a = torch.cat([v.flatten() for v in got["state"][name].values()])
            b = torch.cat([v.flatten() for v in want_state[name].values()])
            assert float((a - b).norm() / b.norm()) <= 1e-9, name
        assert got["state"]["step"] == want_state["step"] == START + 2 * k
        assert got["state"]["nimg"] == want_state["nimg"] == 8 * k
        assert list(got["stats"]) == list(want_stats)
        for key, v in want_stats.items():
            np.testing.assert_allclose(got["stats"][key], v, rtol=1e-6,
                                       atol=1e-12, err_msg=key)
    assert ranks[0]["stats"][tts.R1_RAN].tolist() == [0, 1, 0, 0]


# ---------------------------------------------------------------------------
# the loop's steps_per_call
# ---------------------------------------------------------------------------

STEPS = 6


def _loop_cfg(base, log_dir, spc, **train):
    """smoke_cfg with ticks of 2 steps (batch 8), R1 every 3 steps."""
    cfg = copy.deepcopy(base)
    cfg["train"].update(log_dir=str(log_dir), steps_per_call=spc,
                        kimg_per_tick=0.016, d_reg_interval=3, **train)
    return cfg


def _stats_rows(cfg):
    with open(os.path.join(cfg["train"]["log_dir"], "stats.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_fused_loop_matches_sequential(smoke_cfg, tmp_path):  # noqa: F811
    cfgs = {spc: _loop_cfg(smoke_cfg, tmp_path / f"spc{spc}", spc)
            for spc in (1, 2)}
    states = {spc: loop.train_stage(c, max_steps=STEPS, device="cpu")
              for spc, c in cfgs.items()}
    assert states[2].step == STEPS and states[2].nimg == 8 * STEPS
    _equal(states[2].state_dict(), states[1].state_dict())
    seq, fused = (_stats_rows(cfgs[spc]) for spc in (1, 2))
    assert [r["tick"] for r in fused] == [r["tick"] for r in seq] == [0, 1, 2]
    for a, b in zip(fused, seq):
        assert set(a) == set(b)
        losses = {k: v for k, v in a.items() if k.startswith("Loss/")}
        assert losses == {k: b[k] for k in losses}
    # R1 at steps 0 and 3: once in ticks 0 (steps 0-1) and 1 (2-3), never
    # in tick 2 (4-5)
    assert [r.get("Loss/r1_penalty", {}).get("num") for r in fused] == [
        1.0, 1.0, None]
    assert "Misc/r1_ran" not in fused[0]
    # the same checkpoints: ticks 0 and 2, and the last step
    assert sorted(os.listdir(os.path.join(
        cfgs[2]["train"]["log_dir"], "weight"))) == [
        "step_00000002", "step_00000006"]


@pytest.mark.parametrize("first,then", [(2, 1), (1, 2)])
def test_checkpoint_resumes_across_modes(smoke_cfg, tmp_path,  # noqa: F811
                                         first, then):
    """4 steps with steps_per_call `first`, resumed with `then` to 6:
    the state of 6 uninterrupted sequential steps."""
    straight = loop.train_stage(_loop_cfg(smoke_cfg, tmp_path / "a", 1),
                                max_steps=STEPS, device="cpu")
    loop.train_stage(_loop_cfg(smoke_cfg, tmp_path / "b", first),
                     max_steps=4, device="cpu")
    resumed = loop.train_stage(
        _loop_cfg(smoke_cfg, tmp_path / "c", then,
                  resume_path=str(tmp_path / "b" / "weight")),
        max_steps=STEPS, device="cpu")
    _equal(resumed.state_dict(), straight.state_dict())
