"""The port's StyleGAN2 and Co-Mod-GAN nets (`models/stylegan.py`,
`models/comodgan.py`) against the JAX package on the CPU, on the same
numpy-seeded inputs and JAX-initialized weights carried across by the
`.npz` bridge: the modulated conv, the mapping (truncation, `w_avg`), the
synthesis and torgb layers, the StyleGAN2 generator and discriminator,
the Co-Mod-GAN generator's image and every `res_to_rgb` level with the
same z and `noise_mode="const"`; the parameter counts of the published
teacher by construction on the meta device; the weight bridge both ways.

Tolerance: atol 1e-4 + rtol 1e-4 (float32 sums in another order through
~30 modulated layers, outputs up to ~10), 1e-5 for one layer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from migan_tpu.io import checkpoint as jckpt
from migan_tpu.io import torch_import as jimport
from migan_tpu.models import comodgan as jc
from migan_tpu.models import stylegan as jsg
from migan_tpu_torch.io.train_weights import (
    export_migan_train, import_migan_train, params_to_state, save_train_npz,
)
from migan_tpu_torch.models import comodgan as tc
from migan_tpu_torch.models import stylegan as tsg


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The gate runs 6 test workers on one host: torch's default of one
    thread per core in each of them oversubscribes it several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


ATOL = RTOL = 1e-4
LAYER_TOL = 1e-5
# narrow Co-Mod-GAN: 16 channels at 32 px up to 64 at 4 px
SMALL = dict(resolution=32, ch_base=512, ch_max=64)


def _x(shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _perturb(params, seed):
    """JAX init leaves biases, noise strengths and w_avg at 0; give them
    seeded values so that every path is exercised."""
    rng = np.random.RandomState(seed)
    flat = jckpt._flatten(params)
    for k, v in flat.items():
        leaf = k.split("/")[-1]
        if leaf in ("bias", "noise_strength", "w_avg"):
            flat[k] = np.asarray(rng.randn(*v.shape) * 0.3, np.float32)
    return jckpt._unflatten(flat)


def _to_port(module, params):
    module.load_state_dict(params_to_state(jckpt._flatten(params)),
                           strict=True)
    return module


def _close(got, want, tol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("demodulate,up,k", [(True, 1, 3), (True, 2, 3),
                                             (False, 1, 1)])
def test_modulated_conv2d_matches_jax(demodulate, up, k):
    x = _x((2, 8, 8, 6))
    w = _x((k, k, 6, 10), seed=1)
    s = _x((2, 6), seed=2) + 1.0
    noise = _x((2, 8 * up, 8 * up, 1), seed=3)
    kw = dict(up=up, padding=k // 2, demodulate=demodulate,
              flip_weight=(up == 1))
    want = jsg.modulated_conv2d(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(s),
        noise=jnp.asarray(noise), resample_filter=jsg.setup_filter(
            [1, 3, 3, 1]), **kw)
    got = tsg.modulated_conv2d(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(s),
        noise=torch.from_numpy(noise),
        resample_filter=tsg.setup_filter([1, 3, 3, 1]), **kw)
    _close(got, want, LAYER_TOL)


@pytest.mark.parametrize("psi,cutoff", [(1.0, None), (0.7, None), (0.5, 4)])
def test_mapping_matches_jax(psi, cutoff):
    cfg = jsg.MappingConfig(num_ws=6, num_layers=4)
    params = _perturb(jsg.mapping_init(jax.random.PRNGKey(1), cfg), 3)
    m = _to_port(tsg.MappingNetwork(tsg.MappingConfig(num_ws=6,
                                                      num_layers=4)), params)
    z = _x((3, 512), seed=4)
    want, want_avg = jsg.mapping_apply(params, jnp.asarray(z), cfg,
                                       truncation_psi=psi,
                                       truncation_cutoff=cutoff,
                                       update_w_avg=True)
    got, got_avg = m(torch.from_numpy(z), truncation_psi=psi,
                     truncation_cutoff=cutoff, update_w_avg=True)
    _close(got, want, LAYER_TOL)
    _close(got_avg, want_avg, LAYER_TOL)


@pytest.mark.parametrize("up,noise_mode", [(1, "const"), (2, "const"),
                                           (1, "none")])
def test_synthesis_layer_matches_jax(up, noise_mode):
    res = 8 * up
    p = _perturb(jsg.synthesis_layer_init(jax.random.PRNGKey(2), 6, 10, 3,
                                          32, res), 5)
    layer = _to_port(tsg.SynthesisLayer(6, 10, 3, 32, res), p)
    x, w = _x((2, 8, 8, 6), seed=6), _x((2, 32), seed=7)
    act = jsg.get_unit("lrelu_agc(alpha=0.2, gain=sqrt_2, clamp=256)")
    want = jsg.synthesis_layer_apply(
        p, jnp.asarray(x), jnp.asarray(w), act=act, up=up,
        resample_filter=jsg.setup_filter([1, 3, 3, 1]),
        noise_mode=noise_mode)
    got = layer(torch.from_numpy(x), torch.from_numpy(w),
                act=tsg.get_unit("lrelu_agc(alpha=0.2, gain=sqrt_2, "
                                 "clamp=256)"),
                up=up, resample_filter=tsg.setup_filter([1, 3, 3, 1]),
                noise_mode=noise_mode)
    _close(got, want, LAYER_TOL)


def test_torgb_matches_jax():
    p = _perturb(jsg.torgb_layer_init(jax.random.PRNGKey(3), 10, 3, 1, 32),
                 8)
    layer = _to_port(tsg.ToRGBLayer(10, 3, 1, 32), p)
    x, w = _x((2, 8, 8, 10), seed=9), _x((2, 32), seed=10)
    want = jsg.torgb_layer_apply(p, jnp.asarray(x), jnp.asarray(w))
    _close(layer(torch.from_numpy(x), torch.from_numpy(w)), want,
           LAYER_TOL)


# ---------------------------------------------------------------------------
# nets
# ---------------------------------------------------------------------------

def test_stylegan_generator_matches_jax():
    cfg = jsg.StyleGANConfig(resolution=32, ch_base=512, ch_max=64,
                             w_dim=64)
    map_cfg = jsg.MappingConfig(z_dim=64, w_dim=64, num_ws=cfg.num_ws,
                                num_layers=2)
    params = _perturb(jax.jit(jsg.generator_init, static_argnums=(1, 2))(
        jax.random.PRNGKey(4), map_cfg, cfg), 11)
    g = _to_port(tsg.StyleGANGenerator(
        tsg.MappingConfig(z_dim=64, w_dim=64, num_ws=cfg.num_ws,
                          num_layers=2),
        tsg.StyleGANConfig(resolution=32, ch_base=512, ch_max=64,
                           w_dim=64)), params)
    z = _x((2, 64), seed=12)
    want = jax.jit(lambda p, z_: jsg.generator_apply(
        p, z_, map_cfg, cfg, truncation_psi=0.8, noise_mode="const"))(
        params, jnp.asarray(z))
    with torch.no_grad():
        got = g(torch.from_numpy(z), truncation_psi=0.8, noise_mode="const")
    assert got.shape == (2, 32, 32, 3)
    _close(got, want)


def test_stylegan_discriminator_matches_jax():
    kw = dict(resolution=32, ic_n=4, ch_base=512, ch_max=64)
    params = _perturb(jax.jit(jsg.discriminator_init, static_argnums=1)(
        jax.random.PRNGKey(5), jsg.StyleGANConfig(**kw)), 13)
    d = _to_port(tsg.Discriminator(tsg.StyleGANConfig(**kw)), params)
    x = _x((4, 32, 32, 4), seed=14)
    want = jax.jit(lambda p, x_: jsg.discriminator_apply(
        p, x_, jsg.StyleGANConfig(**kw)))(params, jnp.asarray(x))
    with torch.no_grad():
        got = d(torch.from_numpy(x))
    assert got.shape == (4, 1)
    _close(got, want)


def _comodgan(seed=6):
    jcfg = jc.CoModGANConfig(**SMALL)
    params = _perturb(jax.jit(jc.generator_init, static_argnums=1)(
        jax.random.PRNGKey(seed), jcfg), seed + 10)
    g = _to_port(tc.CoModGANGenerator(tc.CoModGANConfig(**SMALL)), params)
    return jcfg, params, g.eval()


def _inpaint_input(n, res, seed):
    rng = np.random.RandomState(seed)
    img = rng.rand(n, res, res, 3).astype(np.float32) * 2 - 1
    mask = (rng.rand(n, res, res, 1) > 0.4).astype(np.float32)
    return np.concatenate([mask - 0.5, img * mask], axis=-1)


def test_comodgan_generator_matches_jax():
    """The image and every res_to_rgb level, same z, noise 'const'."""
    jcfg, params, g = _comodgan()
    x = _inpaint_input(2, 32, 15)
    z = _x((2, 512), seed=16)
    want, want_inter = jax.jit(lambda p, x_, z_: jc.generator_apply(
        p, x_, jcfg, z=z_, noise_mode="const", return_intermediate=True))(
        params, jnp.asarray(x), jnp.asarray(z))
    with torch.no_grad():
        got, inter = g(torch.from_numpy(x), z=torch.from_numpy(z),
                       noise_mode="const", return_intermediate=True)
    _close(got, want)
    assert sorted(inter["res_to_rgb"]) == sorted(want_inter["res_to_rgb"])
    for r, w in want_inter["res_to_rgb"].items():
        _close(inter["res_to_rgb"][r], w)
    for r, w in want_inter["res_img"].items():
        _close(inter["res_img"][r], w)


def test_teacher_apply_is_frozen_and_draws_from_the_generator():
    """make_teacher_apply: no graph, eval mode, z and noise from the
    generator (the same seed gives the same output)."""
    _, _, g = _comodgan()
    g.train()
    apply = tc.make_teacher_apply(g.cfg)
    x = torch.from_numpy(_inpaint_input(2, 32, 17))
    a, inter = apply(g, x, torch.Generator().manual_seed(3))
    b, _ = apply(g, x, torch.Generator().manual_seed(3))
    c, _ = apply(g, x, torch.Generator().manual_seed(4))
    assert not g.training
    assert not a.requires_grad and all(
        not t.requires_grad for t in inter["res_to_rgb"].values())
    assert torch.equal(a, b) and not torch.allclose(a, c)


@pytest.mark.parametrize("res,count", [(256, 79_177_378),
                                       (512, 79_792_231)])
def test_comodgan_param_counts_by_construction(res, count):
    """BASELINE.md's Co-Mod-GAN counts: the nn.Parameters (noise_const and
    w_avg are buffers), on the meta device."""
    with torch.device("meta"):
        g = tc.CoModGANGenerator(tc.CoModGANConfig(resolution=res))
    assert sum(p.numel() for p in g.parameters()) == count
    assert g.cfg.num_ws == (14 if res == 256 else 16)


# ---------------------------------------------------------------------------
# the weight bridge
# ---------------------------------------------------------------------------

def _stylegan_g_params():
    cfg = jsg.StyleGANConfig(resolution=16, ch_base=256, ch_max=32,
                             w_dim=32)
    map_cfg = jsg.MappingConfig(z_dim=32, w_dim=32, num_ws=cfg.num_ws,
                                num_layers=2)
    params = _perturb(jax.jit(jsg.generator_init, static_argnums=(1, 2))(
        jax.random.PRNGKey(7), map_cfg, cfg), 20)
    module = tsg.StyleGANGenerator(
        tsg.MappingConfig(z_dim=32, w_dim=32, num_ws=cfg.num_ws,
                          num_layers=2),
        tsg.StyleGANConfig(resolution=16, ch_base=256, ch_max=32,
                           w_dim=32))
    return params, module


@pytest.mark.parametrize("net", ["comodgan", "stylegan_g", "stylegan_d"])
def test_npz_round_trip(net, tmp_path):
    """JAX .npz -> port module -> port .npz: every array equal, the const
    and w_avg leaves included."""
    if net == "comodgan":
        _, params, module = _comodgan()
    elif net == "stylegan_g":
        params, module = _stylegan_g_params()
        _to_port(module, params)
    else:
        kw = dict(resolution=16, ic_n=4, ch_base=256, ch_max=32)
        params = jax.jit(jsg.discriminator_init, static_argnums=1)(
            jax.random.PRNGKey(8), jsg.StyleGANConfig(**kw))
        module = _to_port(tsg.Discriminator(tsg.StyleGANConfig(**kw)),
                          params)
    save_train_npz(str(tmp_path / "out.npz"), module)
    flat_in = jckpt._flatten(params)
    flat_out = jckpt._flatten(jckpt.load_npz(str(tmp_path / "out.npz")))
    assert set(flat_in) == set(flat_out)
    if net != "stylegan_d":
        assert any(k.endswith("w_avg") for k in flat_in)
    if net == "stylegan_g":
        assert "synthesis/b4/const" in flat_in
    for k, v in flat_in.items():
        np.testing.assert_array_equal(flat_out[k], v, err_msg=k)


@pytest.mark.parametrize("net", ["comodgan", "stylegan_g"])
def test_reference_state_dict_import(net):
    """A reference-layout state_dict (OIHW, const [C, res, res], w_avg):
    the port's import equals the JAX package's import carried across, and
    its export gives the JAX export back."""
    if net == "comodgan":
        _, params, module = _comodgan()
    else:
        params, module = _stylegan_g_params()
    ref_sd = jimport.export_migan_train(params)
    if net == "stylegan_g":
        # the reference's const is [C, res, res]; JAX's export leaves the
        # NHWC array as it is
        ref_sd["synthesis.b4.const"] = np.transpose(
            ref_sd["synthesis.b4.const"], (2, 0, 1))
    state = import_migan_train(ref_sd)
    want = params_to_state(jckpt._flatten(
        jimport.import_migan_train(ref_sd)))
    assert set(state) == set(want) == set(module.state_dict())
    for k, v in want.items():
        torch.testing.assert_close(state[k], v, rtol=0, atol=0)
    back = export_migan_train(state)
    assert set(back) == set(ref_sd)
    for k, v in ref_sd.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
