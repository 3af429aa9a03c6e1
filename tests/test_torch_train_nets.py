"""The port's training-net slice against the JAX package on the CPU, on the
same numpy-seeded inputs and parameters: `conv2d_resample` in every
ordering, `bias_act` and `lrelu_agc`, the training generator (both
topologies; `const` and `none` noise, with the intermediates the
distillation loss reads), the discriminator, `random` noise from a
`torch.Generator`, the parameter counts of the reference's configs, and
the training-weight formats (the JAX `.npz`, the reference state_dict key
map).

Tolerances: convs 1e-5 (float32 sums in another order); elementwise ops
1e-6; whole nets atol 1e-4 + rtol 1e-4 (some 40 layers of such sums,
outputs up to ~10).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from migan_tpu import ops as jops
from migan_tpu.io import checkpoint as jckpt
from migan_tpu.io import torch_import as jimport
from migan_tpu.models import migan as jm
from migan_tpu.ops.bias_act import activation_funcs as J_ACTIVATIONS
from migan_tpu_torch import ops as tops
from migan_tpu_torch.io import (
    export_migan_train, import_migan_train, load_train_npz, save_train_npz,
)
from migan_tpu_torch.models import migan as tm

NET_ATOL = NET_RTOL = 1e-4
# narrow channels (32 at 32 px .. 256 at 4 px) keep the nets small
SMALL = dict(resolution=32, ch_base=1024, num_reparam_tensors=3)


def _x(shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,up,down,groups", [
    (1, 2, 1, 1),     # 1x1 conv, then FIR up (the synthesis up layer)
    (3, 2, 1, 1),     # generic up: zero-insert + FIR, then the conv
    (3, 1, 2, 1),     # FIR, then the strided conv (encoder down)
    (1, 1, 2, 1),     # discriminator skip
    (3, 1, 1, 1),     # no resampling
    (3, 1, 1, 6),     # depthwise
    (3, 2, 1, 6),     # generic up, grouped
    (3, 2, 2, 3),     # up and down
])
@pytest.mark.parametrize("flip_filter", [False, True])
def test_conv2d_resample_matches_jax(k, up, down, groups, flip_filter):
    x = _x((2, 8, 10, 6))
    w = _x((k, k, 6 // groups, 12), seed=1)
    taps = [1, 2, 3, 1]          # asymmetric, so a flip shows
    kw = dict(up=up, down=down, padding=k // 2, groups=groups,
              flip_weight=(up == 1), flip_filter=flip_filter)
    want = np.asarray(jops.conv2d_resample(
        jnp.asarray(x), jnp.asarray(w), f=jops.setup_filter(taps), **kw))
    got = tops.conv2d_resample(torch.from_numpy(x), torch.from_numpy(w),
                               f=tops.setup_filter(taps), **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("act", sorted(J_ACTIVATIONS))
def test_bias_act_matches_jax(act):
    x = _x((3, 5, 7, 6), seed=2, scale=2.0)
    b = _x((6,), seed=3)
    assert set(tops.activation_funcs) == set(J_ACTIVATIONS)
    for kw in ({}, dict(alpha=0.1, gain=0.7, clamp=1.5)):
        want = np.asarray(jops.bias_act(jnp.asarray(x), jnp.asarray(b),
                                        act=act, **kw))
        got = tops.bias_act(torch.from_numpy(x), torch.from_numpy(b),
                            act=act, **kw).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("gain", [1.0, math.sqrt(0.5), 2.0])
def test_lrelu_agc_runtime_gain_matches_jax(gain):
    """The runtime gain scales the output and the clamp (the
    discriminator's sqrt(0.5)); scaled input so the clamp fires."""
    spec = "lrelu_agc(alpha=0.2, gain=sqrt_2, clamp=256)"
    x = _x((4, 1000), seed=4, scale=300.0)
    unit_j, unit_t = jops.get_unit(spec), tops.get_unit(spec)
    assert (unit_t.alpha, unit_t.gain, unit_t.clamp) == (
        unit_j.alpha, unit_j.gain, unit_j.clamp)
    want = np.asarray(unit_j(jnp.asarray(x), gain=gain))
    got = unit_t(torch.from_numpy(x), gain=gain).numpy()
    assert (np.abs(want) == np.float32(256 * gain)).mean() > 0.1
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert tops.get_unit("none") is None and tops.get_unit(None) is None


# ---------------------------------------------------------------------------
# nets
# ---------------------------------------------------------------------------

def _jax_params(init, cfg, seed, tmp_path, name):
    """JAX params with non-zero biases and noise strengths, and the same
    weights in the port's layout through the JAX `.npz` file."""
    params = init(jax.random.PRNGKey(seed), cfg)
    rng = np.random.RandomState(seed)

    def perturb(path, v):
        if path[-1].key in ("bias", "noise_strength"):
            return jnp.asarray(np.asarray(rng.randn(*v.shape),
                                          np.float32) * 0.3)
        return v

    params = jax.tree_util.tree_map_with_path(perturb, params)
    path = tmp_path / f"{name}.npz"
    jckpt.save_npz(str(path), params)
    return params, load_train_npz(str(path))


def _cfgs(depthwise, reparam):
    kw = dict(SMALL, depthwise=depthwise, reparametrize=reparam)
    return jm.MiganConfig(**kw), tm.MiganConfig(**kw)


@pytest.mark.parametrize("depthwise,reparam", [(True, True), (False, False)])
@pytest.mark.parametrize("noise_mode", ["const", "none"])
def test_generator_matches_jax(depthwise, reparam, noise_mode, tmp_path):
    jcfg, tcfg = _cfgs(depthwise, reparam)
    params, state = _jax_params(jm.generator_init, jcfg, 0, tmp_path, "g")
    g = tm.Generator(tcfg)
    g.load_state_dict(state, strict=True)
    x = _x((2, 32, 32, 4), seed=5)
    want, want_i = jm.generator_apply(params, jnp.asarray(x), jcfg,
                                      noise_mode=noise_mode,
                                      return_intermediate=True)
    with torch.no_grad():
        got, got_i = g(torch.from_numpy(x), noise_mode=noise_mode,
                       return_intermediate=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=NET_RTOL, atol=NET_ATOL)
    for kind in ("res_to_rgb", "res_img"):
        assert sorted(got_i[kind]) == sorted(want_i[kind]) == \
            tcfg.block_res
        for res, w in want_i[kind].items():
            np.testing.assert_allclose(got_i[kind][res].numpy(),
                                       np.asarray(w), rtol=NET_RTOL,
                                       atol=NET_ATOL, err_msg=f"{kind} {res}")


@pytest.mark.parametrize("depthwise,reparam", [(True, True), (False, False)])
def test_discriminator_matches_jax(depthwise, reparam, tmp_path):
    """N = 8 with minibatch-std groups of 4."""
    jcfg, tcfg = _cfgs(depthwise, reparam)
    params, state = _jax_params(jm.discriminator_init, jcfg, 1, tmp_path,
                                "d")
    d = tm.Discriminator(tcfg)
    d.load_state_dict(state, strict=True)
    x = _x((8, 32, 32, 4), seed=6)
    want = np.asarray(jm.discriminator_apply(params, jnp.asarray(x), jcfg))
    with torch.no_grad():
        got = d(torch.from_numpy(x)).numpy()
    assert got.shape == (8, 1)
    np.testing.assert_allclose(got, want, rtol=NET_RTOL, atol=NET_ATOL)


@pytest.mark.parametrize("n,group,channels", [(8, 4, 1), (2, 4, 1),
                                              (6, 3, 2), (4, None, 1)])
def test_minibatch_std_matches_jax(n, group, channels):
    x = _x((n, 4, 4, 6), seed=7)
    want = np.asarray(jm.minibatch_std(jnp.asarray(x), group, channels))
    got = tm.minibatch_std(torch.from_numpy(x), group, channels).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_random_noise_follows_the_torch_generator():
    """`random` draws its noise from the given torch.Generator: the same
    seed gives the same output, another seed another; with every noise
    strength 0 it equals `none`."""
    _, tcfg = _cfgs(True, True)
    g = tm.generator_init(tcfg, torch.Generator().manual_seed(0))
    x = torch.from_numpy(_x((2, 32, 32, 4), seed=8))

    def run(seed):
        with torch.no_grad():
            return g(x, noise_mode="random",
                     generator=torch.Generator().manual_seed(seed))

    with torch.no_grad():
        none = g(x, noise_mode="none")
    assert torch.equal(run(1), none)          # strengths are 0 at init
    with torch.no_grad():
        for name, p in g.named_parameters():
            if name.endswith("noise_strength"):
                p.fill_(0.5)
    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b)
    assert not torch.allclose(a, c)
    with pytest.raises(ValueError, match="torch.Generator"):
        g(x, noise_mode="random")


@pytest.mark.parametrize("net,depthwise,reparam,count", [
    ("G", True, True, 52_686_881),     # the shipped student (BASELINE.md)
    ("D", False, False, 28_864_257),   # migan_d256, as the configs train
    ("D", True, True, 39_002_835),     # the dw + reparam D
])
def test_param_counts_by_construction(net, depthwise, reparam, count):
    """Counted on the meta device at 256: no weights are made, no forward
    runs."""
    cfg = tm.MiganConfig(resolution=256, depthwise=depthwise,
                         reparametrize=reparam, num_reparam_tensors=9)
    with torch.device("meta"):
        module = (tm.Generator if net == "G" else tm.Discriminator)(cfg)
    assert tm.count_params(module) == count


# ---------------------------------------------------------------------------
# weight formats
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("net", ["G", "D"])
def test_train_npz_round_trip(net, tmp_path):
    """JAX .npz -> port module -> port .npz -> JAX: every array equal."""
    jcfg, tcfg = _cfgs(True, True)
    init = jm.generator_init if net == "G" else jm.discriminator_init
    params, state = _jax_params(init, jcfg, 2, tmp_path, "in")
    module = (tm.Generator if net == "G" else tm.Discriminator)(tcfg)
    module.load_state_dict(state, strict=True)
    save_train_npz(str(tmp_path / "out.npz"), module)
    back = jckpt.load_npz(str(tmp_path / "out.npz"))
    flat_in = jckpt._flatten(params)
    flat_out = jckpt._flatten(back)
    assert set(flat_in) == set(flat_out)
    for k, v in flat_in.items():
        assert flat_out[k].shape == v.shape, k
        np.testing.assert_array_equal(flat_out[k], v, err_msg=k)


@pytest.mark.parametrize("net", ["G", "D"])
def test_reference_key_map_matches_jax(net, tmp_path):
    """The reference state_dict layout (w0..wN-1, OIHW, resample_filter
    buffers): the port's import and export agree with the JAX package's."""
    jcfg, _ = _cfgs(True, True)
    init = jm.generator_init if net == "G" else jm.discriminator_init
    params, state = _jax_params(init, jcfg, 3, tmp_path, "p")
    ref_sd = jimport.export_migan_train(params)
    assert any(k.endswith(".w2") for k in ref_sd)
    ref_sd["encoder.b32.conv1.conv1.resample_filter"
           if net == "G" else "b32.conv1.conv1.resample_filter"] = \
        np.ones((4, 4), np.float32)
    imported = import_migan_train(ref_sd)
    assert set(imported) == set(state)
    for k, v in state.items():
        torch.testing.assert_close(imported[k], v, rtol=0, atol=0)
    exported = export_migan_train(state)
    want = jimport.export_migan_train(params)
    assert set(exported) == set(want)
    for k, v in want.items():
        assert exported[k].shape == v.shape, k
        np.testing.assert_array_equal(exported[k], v, err_msg=k)
    with pytest.raises(ValueError, match="unrecognized"):
        import_migan_train({"encoder.b32.conv1.conv1.mystery": np.zeros(1)})
