"""The port's training losses and train step (`train/loss.py`,
`train/train_step.py`) against the JAX package on the CPU.

The nets are carried across from JAX initializations (biases, noise
strengths seeded non-zero); the inputs are numpy-seeded. jax.random and
torch draw different streams, so the same numpy-seeded draws (the
generator's noise, the teacher's z and noise) are fed to both sides, in
call order, by test-local patches of `torch.randn` and
`jax.random.normal` (`_Noise`); the JAX losses run jitted, as its own
tests run them.

Tolerances: loss values rtol 1e-5 (float32, sums in another order);
gradients relative L2 <= 1e-4 per tensor; Adam against optax on the same
gradients atol 1e-7; EMA and sanitizing elementwise at float32 ulps.
Parameters after an Adam step are not compared elementwise: with
beta1 = 0 the first update is ~lr * sign(g), whose sign flips where g is
within rounding of 0.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from migan_tpu import ops as jops
from migan_tpu.io import checkpoint as jckpt
from migan_tpu.models import comodgan as jc
from migan_tpu.models import migan as jm
from migan_tpu.train import loss as jl
from migan_tpu.train import train_step as jts
from migan_tpu_torch import ops as tops
from migan_tpu_torch.io.train_weights import params_to_state, state_to_params
from migan_tpu_torch.models import comodgan as tc
from migan_tpu_torch.models import migan as tm
from migan_tpu_torch.train import loss as tl
from migan_tpu_torch.train import train_step as tts


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The gate runs 6 test workers on one host: torch's default of one
    thread per core in each of them oversubscribes it several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


GRAD_RTOL = 1e-4
LOSS_RTOL = 1e-5
# 8 px nets (64 channels at 8 px, 128 at 4), KD on both levels
NET = dict(resolution=8, ch_base=512, depthwise=True, reparametrize=True,
           num_reparam_tensors=2)
TEACHER = dict(resolution=8, ch_base=128, ch_max=32)
KD = dict(start_resolution=4, weight=2.0)


def _perturb(params, seed):
    rng = np.random.RandomState(seed)
    flat = jckpt._flatten(params)
    for k, v in flat.items():
        if k.split("/")[-1] in ("bias", "noise_strength", "w_avg"):
            flat[k] = np.asarray(rng.randn(*v.shape) * 0.3, np.float32)
    return jckpt._unflatten(flat)


def _port(module, params):
    module.load_state_dict(params_to_state(jckpt._flatten(params)),
                           strict=True)
    return module


def _nets(seed=0):
    jcfg = jm.MiganConfig(**NET)
    pg = _perturb(jax.jit(jm.generator_init, static_argnums=1)(
        jax.random.PRNGKey(seed), jcfg), seed)
    pd = _perturb(jax.jit(jm.discriminator_init, static_argnums=1)(
        jax.random.PRNGKey(seed + 1), jcfg), seed + 1)
    G = _port(tm.Generator(tm.MiganConfig(**NET)), pg)
    D = _port(tm.Discriminator(tm.MiganConfig(**NET)), pd)
    return jcfg, pg, pd, G, D


def _teacher(seed=5):
    """The teacher, its torgb biases raised by 3 so that its res_to_rgb
    stays clear of the student's: the KD L1's gradient is sign(g - t), and
    where g - t is within rounding of 0 the two frameworks may take either
    sign."""
    jcfg = jc.CoModGANConfig(**TEACHER)
    params = _perturb(jax.jit(jc.generator_init, static_argnums=1)(
        jax.random.PRNGKey(seed), jcfg), seed)
    flat = jckpt._flatten(params)
    for k in flat:
        if k.endswith("torgb/bias"):
            flat[k] = flat[k] + 3.0
    params = jckpt._unflatten(flat)
    module = _port(tc.CoModGANGenerator(tc.CoModGANConfig(**TEACHER)),
                   params)
    return ((jc.make_teacher_apply(jcfg), params),
            (tc.make_teacher_apply(module.cfg), module))


def _batch(n=4, res=8, seed=3):
    rng = np.random.RandomState(seed)
    real = rng.rand(n, res, res, 3).astype(np.float32) * 2 - 1
    mask = (rng.rand(n, res, res, 1) > 0.4).astype(np.float32)
    return real, mask


class _Noise:
    """Feeds the same numpy-seeded N(0, 1) draws to both frameworks, by
    test-local patches: the port runs first and its `torch.randn` calls
    draw them from a RandomState, in call order; then JAX's
    `jax.random.normal` calls, traced once under jit, return them in the
    same order (the shapes checked)."""

    def __init__(self, monkeypatch, seed=0):
        self.mp = monkeypatch
        self.rng = np.random.RandomState(seed)
        self.draws = []
        self._randn = torch.randn

    def port(self):
        def fake(*shape, generator=None, device=None, dtype=None, **kw):
            if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
                shape = tuple(shape[0])
            a = self.rng.randn(*shape).astype(np.float32)
            self.draws.append(a)
            return torch.from_numpy(a.copy()).to(device=device,
                                                 dtype=dtype or torch.float32)

        self.mp.setattr(torch, "randn", fake)

    def jax(self):
        self.mp.setattr(torch, "randn", self._randn)
        it = iter(self.draws)

        def fake(key, shape=(), dtype=jnp.float32):
            a = next(it)
            assert a.shape == tuple(shape), (a.shape, shape)
            return jnp.asarray(a, dtype)

        self.mp.setattr(jax.random, "normal", fake)
        return it


def _jax_grad(loss_fn, params):
    """(loss, stats, grads) of loss_fn(params) -> (loss, stats), jitted."""
    (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    return loss, stats, grads


def _rel_l2(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy()
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                 1e-30))


def _grads(loss, module):
    """d loss / d every parameter of `module`, zeros where unused (the
    output bias in R1), as jax.grad gives them."""
    params = list(module.parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, grads)]


def _check_grads(module, grads, jax_grads):
    """Every parameter's gradient against JAX's, in the JAX layout."""
    names = [n for n, _ in module.named_parameters()]
    flat = state_to_params(dict(zip(names, grads)))
    want = jckpt._flatten(jax_grads)
    assert set(flat) <= set(want)
    for k, g in flat.items():
        w = want[k]
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= GRAD_RTOL, (k, err)


def _scalar_close(got, want, rtol=LOSS_RTOL):
    got = got.detach() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(float(got), float(want), rtol=rtol,
                               atol=1e-7)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kd", [False, True])
def test_g_loss_matches_jax(kd, monkeypatch):
    """Gmain with random noise, and with multi-resolution KD through a
    tuple-form teacher (random z and noise, replayed)."""
    jcfg, pg, pd, G, D = _nets()
    real, mask = _batch()
    (j_teacher, t_teacher) = _teacher() if kd else (None, None)
    jtf = None if j_teacher is None else (
        lambda x, k: j_teacher[0](j_teacher[1], x, k))
    ttf = tts.normalize_teacher(t_teacher)
    j_cfg = jl.LossConfig(kd=jl.KDConfig(**KD) if kd else None)
    t_cfg = tl.LossConfig(kd=tl.KDConfig(**KD) if kd else None)
    noise = _Noise(monkeypatch, 7)
    noise.port()
    r, m = torch.from_numpy(real), torch.from_numpy(mask)
    loss, stats = tl.g_loss(G, D, r, m, r * m, torch.Generator(), t_cfg,
                            ttf)
    grads = _grads(loss, G)
    it = noise.jax()
    want, want_stats, jgrads = _jax_grad(
        lambda p: jl.g_loss(p, pd, jnp.asarray(real), jnp.asarray(mask),
                            jnp.asarray(real * mask), jax.random.PRNGKey(7),
                            jcfg, jcfg, j_cfg, jtf), pg)
    assert next(it, None) is None                 # every draw consumed
    _scalar_close(loss, want)
    assert set(stats) == set(want_stats)
    for k, v in want_stats.items():
        _scalar_close(stats[k], v)
    _check_grads(G, grads, jgrads)


def test_d_loss_matches_jax(monkeypatch):
    jcfg, pg, pd, G, D = _nets(2)
    real, mask = _batch(seed=4)
    noise = _Noise(monkeypatch, 8)
    noise.port()
    r, m = torch.from_numpy(real), torch.from_numpy(mask)
    loss, stats = tl.d_loss(D, G, r, m, r * m, torch.Generator())
    grads = _grads(loss, D)
    noise.jax()
    want, want_stats, jgrads = _jax_grad(
        lambda p: jl.d_loss(p, pg, jnp.asarray(real), jnp.asarray(mask),
                            jnp.asarray(real * mask), jax.random.PRNGKey(8),
                            jcfg, jcfg), pd)
    _scalar_close(loss, want)
    for k, v in want_stats.items():
        _scalar_close(stats[k], v)
    _check_grads(D, grads, jgrads)


def test_d_r1_loss_matches_jax():
    """R1: the penalty and its gradient with respect to D's parameters,
    a double backward through the whole discriminator."""
    jcfg, _, pd, _, D = _nets(4)
    real, mask = _batch(seed=5)

    want, want_stats, jgrads = _jax_grad(
        lambda p: jl.d_r1_loss(p, jnp.asarray(real), jnp.asarray(mask),
                               jcfg, 10.0), pd)
    loss, stats = tl.d_r1_loss(D, torch.from_numpy(real),
                               torch.from_numpy(mask), 10.0)
    _scalar_close(loss, want)
    for k, v in want_stats.items():
        _scalar_close(stats[k], v)
    _check_grads(D, _grads(loss, D), jgrads)


@pytest.mark.parametrize("k,up,down,groups", [
    (3, 1, 2, 1), (1, 1, 2, 1), (3, 2, 1, 1), (1, 2, 1, 1), (3, 1, 1, 1),
    (3, 1, 1, 4), (3, 1, 2, 4), (3, 2, 1, 4)])    # groups 4: depthwise
@pytest.mark.parametrize("act", [
    dict(act="lrelu", alpha=0.2, gain=math.sqrt(2), clamp=2.0),
    dict(act="swish", gain=1.5)])
def test_r1_double_backward_through_ops(k, up, down, groups, act):
    """The double backward of `conv2d_resample` (the FIR's depthwise
    convolution and, with groups = channels, a depthwise weight:
    `ops/depthwise.py`) and `bias_act` alone: L(w, b) = sum((d/dx
    sum(act(conv(x, w) + b)))^2), differentiated with respect to w and b,
    against jax.grad of jax.grad. (With lrelu, the training nets'
    activation, L does not depend on b: both give 0.)"""
    rng = np.random.RandomState(k * 10 + up + down + groups)
    oc = 4 if groups > 1 else 6
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    w = rng.randn(k, k, 4 // groups, oc).astype(np.float32) * 0.3
    b = rng.randn(oc).astype(np.float32) * 0.3
    kw = dict(up=up, down=down, padding=k // 2, flip_weight=(up == 1),
              groups=groups)

    def jf(w_, b_):
        def inner(x_):
            y = jops.conv2d_resample(x_, w_, f=jops.setup_filter(
                [1, 3, 3, 1]), **kw)
            return jnp.sum(jops.bias_act(y, b_, **act))
        return jnp.sum(jnp.square(jax.grad(inner)(jnp.asarray(x))))

    want = jf(jnp.asarray(w), jnp.asarray(b))
    jw, jb = jax.grad(jf, argnums=(0, 1))(jnp.asarray(w), jnp.asarray(b))

    tw = torch.from_numpy(w).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    y = tops.bias_act(tops.conv2d_resample(
        tx, tw, f=tops.setup_filter([1, 3, 3, 1]), **kw), tb, **act)
    (gx,) = torch.autograd.grad(y.sum(), tx, create_graph=True)
    loss = gx.square().sum()
    gw, gb = torch.autograd.grad(loss, (tw, tb), allow_unused=True)
    gb = torch.zeros_like(tb) if gb is None else gb
    _scalar_close(loss, want)
    assert _rel_l2(gw, jw) <= GRAD_RTOL
    assert _rel_l2(gb, jb) <= GRAD_RTOL


# ---------------------------------------------------------------------------
# the step's pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reg_interval", [None, 4, 16])
def test_adam_matches_optax(reg_interval):
    """make_optimizer (the mb_ratio on lr and betas) against optax.adam
    on the same gradients, three steps."""
    opt = tts.OptConfig(reg_interval=reg_interval, beta1=0.0)
    jopt = jts.OptConfig(reg_interval=reg_interval, beta1=0.0)
    rng = np.random.RandomState(0)
    p0 = rng.randn(5, 7).astype(np.float32)
    grads = [rng.randn(5, 7).astype(np.float32) * s for s in (1, 1e-3, 10)]
    tx = jts.make_optimizer(jopt)
    jp, st = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    adam = tts.make_optimizer([tp], opt)
    for g in grads:
        upd, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(g)
        adam.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                               rtol=0, atol=1e-7)


def test_sanitize_grads_matches_jax():
    g = np.array([0.5, np.nan, np.inf, -np.inf, -2.0, 3e5], np.float32)
    want = jts._sanitize_grads({"g": jnp.asarray(g)})["g"]
    (got,) = tts._sanitize_grads([torch.from_numpy(g)])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("rampup,nimg", [(None, 64), (0.05, 64),
                                         (0.05, 10 ** 7)])
def test_ema_update_matches_jax(rampup, nimg):
    """Parameters lerped with JAX's beta; noise_const copied verbatim."""
    jcfg = jm.MiganConfig(**NET)
    init = jax.jit(jm.generator_init, static_argnums=1)
    pg = _perturb(init(jax.random.PRNGKey(0), jcfg), 0)
    pe = _perturb(init(jax.random.PRNGKey(1), jcfg), 1)
    cfg_j = jts.TrainConfig(batch_size=32, ema_kimg=0.5, ema_rampup=rampup)
    cfg_t = tts.TrainConfig(batch_size=32, ema_kimg=0.5, ema_rampup=rampup)
    want = jts.ema_update(pg, pe, jnp.asarray(nimg, jnp.int32), cfg_j)
    G = _port(tm.Generator(tm.MiganConfig(**NET)), pg)
    E = _port(tm.Generator(tm.MiganConfig(**NET)), pe)
    tts.ema_update(G, E, nimg, cfg_t)
    got = state_to_params(E.state_dict())
    for k, v in jckpt._flatten(want).items():
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=0,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("rounds", [1, 2, 4])
def test_accum_grads_matches_jax(rounds):
    rng = np.random.RandomState(rounds)
    x = rng.randn(8, 5).astype(np.float32)
    w = rng.randn(5, 3).astype(np.float32)

    def jloss(p, xb):
        y = xb @ p["w"]
        return jnp.mean(jnp.square(y)), {"m": jnp.mean(y)}

    jg, jstats = jts._accum_grads(jloss, {"w": jnp.asarray(w)},
                                  (jnp.asarray(x),), rounds)
    tw = torch.from_numpy(w).requires_grad_()

    def tloss(xb):
        y = xb @ tw
        return y.square().mean(), {"m": y.mean().detach()}

    (g,), stats = tts._accum_grads(tloss, [tw], (torch.from_numpy(x),),
                                   rounds)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg["w"]), rtol=1e-6,
                               atol=1e-6)
    _scalar_close(stats["m"], jstats["m"])


def test_decode_batch_matches_jax():
    rng = np.random.RandomState(0)
    real = rng.randint(0, 256, (2, 4, 4, 3), np.uint8)
    mask = (rng.rand(2, 4, 4, 1) > 0.5).astype(np.uint8)
    jr, jmask = jts._decode_batch(jnp.asarray(real), jnp.asarray(mask))
    tr, tmask = tts.decode_batch(torch.from_numpy(real),
                                 torch.from_numpy(mask))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0,
                               atol=1e-7)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    f = np.zeros((1, 2, 2, 3), np.float32)
    assert tts.decode_batch(torch.from_numpy(f),
                            torch.from_numpy(f))[0].dtype == torch.float32


# ---------------------------------------------------------------------------
# one full step
# ---------------------------------------------------------------------------

def test_full_step_matches_jax(monkeypatch):
    """One step (Gmain with KD, Dmain on the updated G, Dreg, EMA) from the
    same state through both packages' `make_train_step`: every loss, each
    phase's gradients, and the EMA. A spy on the JAX package's
    `_sanitize_grads` hands each phase's gradients out of its jitted
    program by `jax.debug.callback`; the port's are taken where `_apply`
    hands them to Adam. Both sides run in float64, so that
    the comparison sees the step and not float32 rounding amplified at
    the kinks of lrelu and the L1 (in float32 the phases' gradients agree
    to ~2e-4 relative L2 at these seeds; the loss tests above hold each
    loss's float32 gradients to 1e-4). The EMA is held against JAX's
    `ema_update` of the port's updated G and the initial EMA (the updated
    G itself is not compared elementwise; see the module's docstring)."""
    f64 = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: jnp.asarray(a, jnp.float64), t)
    jcfg, pg, pd, G, D = _nets(6)
    (j_apply, j_tparams), t_teacher = _teacher(7)
    G, D = G.double(), D.double()
    t_teacher[1].double()
    real, mask = (a.astype(np.float64) for a in _batch(seed=8))
    # EMA half-life of one batch: beta = 0.5, the EMA lands halfway
    ema = dict(batch_size=4, ema_kimg=0.004, ema_rampup=None)
    cfg_j = jts.TrainConfig(**ema, loss=jl.LossConfig(kd=jl.KDConfig(**KD)))
    cfg_t = tts.TrainConfig(**ema, loss=tl.LossConfig(kd=tl.KDConfig(**KD)))
    noise = _Noise(monkeypatch, 11)
    noise.port()
    applied = []
    orig_apply = tts._apply

    def spy(opt, params, grads):
        applied.append([g.clone() for g in grads])
        orig_apply(opt, params, grads)

    monkeypatch.setattr(tts, "_apply", spy)
    state = tts.state_from_modules(G, D, cfg_t)
    step = tts.make_train_step(G.cfg, D.cfg, cfg_t, teacher=t_teacher)
    stats = step(state, {"real": torch.from_numpy(real),
                         "mask": torch.from_numpy(mask)},
                 torch.Generator(), do_dr1=True)
    assert len(applied) == 3 and state.step == 1 and state.nimg == 4

    it = noise.jax()
    jgrads = []
    orig_sanitize = jts._sanitize_grads

    def sanitize_spy(grads):
        out = orig_sanitize(grads)
        jax.debug.callback(jgrads.append, out)
        return out

    monkeypatch.setattr(jts, "_sanitize_grads", sanitize_spy)
    with jax.enable_x64(True):
        pg, pd, j_tparams = f64(pg), f64(pd), f64(j_tparams)
        jstate = jts.TrainState(
            params_G=pg, params_D=pd, params_G_ema=pg,
            opt_G=jts.make_optimizer(cfg_j.g_opt).init(pg),
            opt_D=jts.make_optimizer(cfg_j.d_opt).init(pd),
            step=jnp.zeros((), jnp.int32), nimg=jnp.zeros((), jnp.int32))
        jstep = jts.make_train_step(jcfg, jcfg, cfg_j,
                                    teacher_fn=(j_apply, j_tparams))
        jnew, want = jstep(jstate, {"real": jnp.asarray(real),
                                    "mask": jnp.asarray(mask)},
                           jax.random.PRNGKey(11), do_dr1=True)
        ema_want = jts.ema_update(
            f64(jckpt._unflatten(state_to_params(state.G.state_dict()))),
            pg, jnp.asarray(state.nimg, jnp.int32), cfg_j)
    assert next(it, None) is None
    assert len(jgrads) == 3 and int(jnew.step) == 1 and int(jnew.nimg) == 4

    assert set(stats) == set(want)
    for k, v in want.items():
        _scalar_close(stats[k], v)
    for module, grads, jg in zip((G, D, D), applied, jgrads):
        _check_grads(module, grads, jg)
    # the weight bridge writes float32: each side rounds once to it, and
    # the lerp rounds at the scale of its larger end (atol; an Adam step
    # moves a parameter by ~lr = 2e-3)
    got = state_to_params(state.G_ema.state_dict())
    for k, v in jckpt._flatten(ema_want).items():
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=2 ** -23,
                                   atol=1e-9, err_msg=k)
    # the EMA moved from G's initial values, by about half an Adam step
    k = "synthesis/b8/torgb/bias"
    assert np.abs(got[k] - jckpt._flatten(pg)[k]).max() > 1e-4
