"""The port's training-time metric stack against the JAX package on the
CPU: `evalx/fid.py` (`FeatureStats` streaming with `max_items`, its
save/load, `stats_cache_path`), the NVIDIA TF-named Inception flavor of
`evalx/inception.py` (`tf_resize_bilinear`, `inception_apply_nvidia`,
`make_detector`, `import_inception_tf_names`,
`import_inception_torchscript`, `load_inception_weights`), the registry
of `evalx/metrics.py` (`calc_metric`, `report_metric`) and
`evalx/evaluators.py` (psnr, ssim, lpips, compose, null).

Tolerances: FeatureStats exact (the same float64 numpy arithmetic); the
resize atol 1e-4 on [0, 255]; detector features rtol 1e-3 and atol 1e-4
against JAX and against `tests/torch_oracles.TorchNVIDIAInception`, as
`tests/test_detector_parity.py`; FID 1e-3 relative of the JAX value
(features float32 in another summation order, then one 2048-dim `sqrtm`
on each side); psnr rtol 1e-6, ssim 1e-5, lpips 1e-4.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from migan_tpu.data import factory as jfactory
from migan_tpu.evalx import evaluators as jev
from migan_tpu.evalx import fid as jfid
from migan_tpu.evalx import inception as jinc
from migan_tpu.evalx import lpips as jlp
from migan_tpu.evalx import metrics as jmet
from migan_tpu.io import checkpoint as jckpt
from migan_tpu.models import migan as jm
from migan_tpu_torch.data import factory as tfactory
from migan_tpu_torch.evalx import evaluators as tev
from migan_tpu_torch.evalx import fid as tfid
from migan_tpu_torch.evalx import inception as tinc
from migan_tpu_torch.evalx import lpips as tlp
from migan_tpu_torch.evalx import metrics as tmet
from migan_tpu_torch.io.train_weights import params_to_state
from migan_tpu_torch.models import migan as tm
from torch_oracles import TorchNVIDIAInception, randomize_inception_


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The gate runs 6 test workers on one host: torch's default of one
    thread per core in each of them oversubscribes it several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


DET_RTOL, DET_ATOL = 1e-3, 1e-4
FID_RTOL = 1e-3


# ---------------------------------------------------------------------------
# FeatureStats, the cache path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_items", [None, 10, 16])
def test_feature_stats_equal_to_jax(tmp_path, max_items):
    rng = np.random.RandomState(0)
    got = tfid.FeatureStats(max_items=max_items)
    want = jfid.FeatureStats(max_items=max_items)
    for n in (4, 4, 5, 3):
        x = rng.randn(n, 6).astype(np.float32)
        got.append(x)
        want.append(x)
        assert got.num_items == want.num_items
        assert got.is_full() == want.is_full()
    assert got.num_items == (16 if max_items is None else max_items)
    np.testing.assert_array_equal(got.raw_mean, want.raw_mean)
    np.testing.assert_array_equal(got.raw_cov, want.raw_cov)
    for a, b in zip(got.get_mean_cov(), want.get_mean_cov()):
        np.testing.assert_array_equal(a, b)
    # either package reads the other's file
    got.save(str(tmp_path / "port.pkl"))
    want.save(str(tmp_path / "jax.pkl"))
    for path in ("port.pkl", "jax.pkl"):
        for cls in (tfid.FeatureStats, jfid.FeatureStats):
            back = cls.load(str(tmp_path / path))
            assert back.num_items == got.num_items
            assert back.max_items == max_items
            np.testing.assert_array_equal(back.raw_cov, got.raw_cov)
    with pytest.raises(ValueError):
        tfid.FeatureStats().append(np.zeros(3))


def test_stats_cache_path_equal_to_jax(tmp_path):
    for key in (("places2_val256", "inception-nvidia_tf", 10000),
                ("", "inception", None)):
        got = tfid.stats_cache_path(str(tmp_path / "a"), *key)
        want = jfid.stats_cache_path(str(tmp_path / "b"), *key)
        assert os.path.basename(got) == os.path.basename(want)
        assert os.path.isdir(tmp_path / "a")


# ---------------------------------------------------------------------------
# The NVIDIA TF-named detector
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("res", [64, 256])
def test_tf_resize_bilinear_equal_to_jax(res):
    x = np.random.RandomState(res).rand(2, res, res, 3).astype(
        np.float32) * 255
    got = tinc.tf_resize_bilinear(torch.from_numpy(x), 299, 299).numpy()
    want = np.asarray(jinc.tf_resize_bilinear(jnp.asarray(x), 299, 299))
    assert got.shape == (2, 299, 299, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # anchored at the top-left corner, no half-pixel offset
    np.testing.assert_allclose(got[:, 0, 0], x[:, 0, 0], atol=1e-4)


@pytest.fixture(scope="module")
def nvidia_oracle():
    model = randomize_inception_(TorchNVIDIAInception(), seed=3)
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    return model, sd


@pytest.mark.parametrize("res", [64, 256])
def test_inception_apply_nvidia_against_jax_and_oracle(nvidia_oracle, res):
    model, sd = nvidia_oracle
    x = np.random.RandomState(res).randint(0, 256, (2, res, res, 3)).astype(
        np.float32)
    got = tinc.inception_apply_nvidia(tinc.import_inception_tf_names(sd),
                                      torch.from_numpy(x)).numpy()
    want = np.asarray(jinc.inception_apply_nvidia(
        jinc.import_inception_tf_names(sd), jnp.asarray(x)))
    with torch.no_grad():
        oracle = model(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    assert got.shape == (2, 2048)
    np.testing.assert_allclose(got, want, rtol=DET_RTOL, atol=DET_ATOL)
    np.testing.assert_allclose(got, oracle, rtol=DET_RTOL, atol=DET_ATOL)


def test_load_inception_weights_flavors(tmp_path, nvidia_oracle):
    """Flavor auto-detection for both layouts and a TorchScript archive,
    the mismatch ValueError, and `make_detector` of each flavor (NHWC in
    [0, 1]) against the JAX package's; nvidia_tf against the oracle on
    the uint8 grid."""
    model, sd = nvidia_oracle
    p_nv = tmp_path / "inception-2015-12-05.pt"
    p_tv = tmp_path / "pt_inception.pth"
    p_ts = tmp_path / "inception_ts.pt"
    p_seeded = tmp_path / "seeded_nv.pt"
    torch.save(model.state_dict(), p_nv)
    torch.save(tinc.seeded_state_dict(1), p_tv)
    torch.jit.trace(model, torch.rand(1, 3, 64, 64) * 255,
                    check_trace=False).save(str(p_ts))
    torch.save(tinc.seeded_state_dict(1, flavor="nvidia_tf"), p_seeded)
    x01 = np.random.RandomState(9).rand(2, 64, 64, 3).astype(np.float32)
    for path, flavor in ((p_nv, "nvidia_tf"), (p_tv, "pytorch_fid"),
                         (p_ts, "nvidia_tf"), (p_seeded, "nvidia_tf")):
        got_m, got_f = tinc.load_inception_weights(str(path))
        want_p, want_f = jinc.load_inception_weights(str(path))
        assert got_f == want_f == flavor
        got = tinc.make_detector(got_m, got_f)(torch.from_numpy(x01))
        want = np.asarray(jinc.make_detector(want_p, want_f)(
            jnp.asarray(x01)))
        np.testing.assert_allclose(got.numpy(), want, rtol=DET_RTOL,
                                   atol=DET_ATOL)
        other = "pytorch_fid" if flavor == "nvidia_tf" else "nvidia_tf"
        with pytest.raises(ValueError, match="flavor"):
            tinc.load_inception_weights(str(path), flavor=other)
    with torch.no_grad():
        oracle = model(torch.from_numpy(np.floor(
            x01 * 255 + 0.5).transpose(0, 3, 1, 2))).numpy()
    det = tinc.make_detector(tinc.import_inception_torchscript(str(p_ts)),
                             "nvidia_tf")
    np.testing.assert_allclose(det(torch.from_numpy(x01)).numpy(), oracle,
                               rtol=DET_RTOL, atol=DET_ATOL)
    bad = dict(sd)
    bad.pop("layers.mixed_4.tower.conv_1.conv.weight")
    with pytest.raises(ValueError, match="mixed_4.tower.conv_1"):
        tinc.import_inception_tf_names(bad)


# ---------------------------------------------------------------------------
# The metric registry: an FID of the same generator and data
# ---------------------------------------------------------------------------

NET = dict(resolution=16, ch_base=512, depthwise=True, reparametrize=True,
           num_reparam_tensors=2)


def _places_cfg(root):
    return {"name": "metric_ds", "type": "places2", "root_dir": root,
            "mode": "train256",
            "loader": [{"type": "DefaultLoader", "args": {}}],
            "formatter": {"type": "FreeFormMaskFormatter",
                          "args": {"resolution": 16, "random_flip": True,
                                   "hole_range": [0.0, 1.0]}}}


def _generators(seed=0):
    """The JAX training generator (biases and noise strengths non-zero)
    and the port's with the same weights."""
    jcfg = jm.MiganConfig(**NET)
    params = jax.jit(jm.generator_init, static_argnums=1)(
        jax.random.PRNGKey(seed), jcfg)
    flat = jckpt._flatten(params)
    rng = np.random.RandomState(seed)
    for k, v in flat.items():
        if k.split("/")[-1] in ("bias", "noise_strength"):
            flat[k] = np.asarray(rng.randn(*v.shape) * 0.3, np.float32)
    G = tm.Generator(tm.MiganConfig(**NET))
    G.load_state_dict(params_to_state(flat), strict=True)
    params = jckpt._unflatten(flat)
    jgen = jax.jit(lambda x: jm.generator_apply(params, x, jcfg,
                                                noise_mode="const"))
    return jgen, lambda x: tm.generator_apply(G, x, noise_mode="const")


def _png_tree(root, n=8):
    d = root / "train_256" / "a"
    d.mkdir(parents=True)
    rng = np.random.RandomState(0)
    for i in range(n):
        Image.fromarray(rng.randint(0, 255, (24, 20, 3), np.uint8)).save(
            d / f"{i}.png")
    return str(root)


def test_calc_metric_fid_equal_to_jax(tmp_path):
    """fid5k_full_inpainting capped at 8 items, batch 4, on the NVIDIA
    detector's seeded weights, the same generator weights and the same
    global np.random seed on each side (the datasets draw masks and flips
    from it); the real-feature caches get the same name and statistics."""
    root = _png_tree(tmp_path)
    jgen, tgen = _generators()
    path = tmp_path / "nv.pt"
    torch.save(tinc.seeded_state_dict(2, flavor="nvidia_tf"), path)
    tdet_m, flavor = tinc.load_inception_weights(str(path))
    jdet_p, _ = jinc.load_inception_weights(str(path))
    common = dict(detector_tag=f"inception-{flavor}", batch_size=4,
                  max_items=8, dataset_tag="metric_ds")
    np.random.seed(3)
    got = tmet.calc_metric(
        "fid5k_full_inpainting",
        dataset=tfactory.get_dataset(_places_cfg(root)), generator_fn=tgen,
        detector_fn=tinc.make_detector(tdet_m, flavor),
        cache_dir=str(tmp_path / "port_cache"), **common)
    np.random.seed(3)
    want = jmet.calc_metric(
        "fid5k_full_inpainting",
        dataset=jfactory.get_dataset(_places_cfg(root)), generator_fn=jgen,
        detector_fn=jinc.make_detector(jdet_p, flavor),
        cache_dir=str(tmp_path / "jax_cache"), **common)
    assert got["metric"] == "fid5k_full_inpainting" and got["total_time"] > 0
    g, w = got["results"]["fid"], want["results"]["fid"]
    assert np.isfinite(g) and g > 0
    assert abs(g - w) <= FID_RTOL * abs(w), (g, w)
    (pc,) = os.listdir(tmp_path / "port_cache")
    assert os.listdir(tmp_path / "jax_cache") == [pc]
    a = tfid.FeatureStats.load(str(tmp_path / "port_cache" / pc))
    b = jfid.FeatureStats.load(str(tmp_path / "jax_cache" / pc))
    assert a.num_items == b.num_items == 8
    np.testing.assert_allclose(a.raw_mean, b.raw_mean, rtol=DET_RTOL,
                               atol=8 * DET_ATOL)

    tmet.report_metric(got, run_dir=str(tmp_path))
    with open(tmp_path / "metric-fid5k_full_inpainting.jsonl") as f:
        (rec,) = [json.loads(line) for line in f]
    assert rec["results"]["fid"] == g and "timestamp" in rec
    assert tmet.is_valid_metric("fid10k_full_inpainting")
    assert sorted(tmet.list_valid_metrics()) == sorted(
        jmet.list_valid_metrics())
    with pytest.raises(ValueError, match="fid1k"):
        tmet.calc_metric("fid1k_full_inpainting")


# ---------------------------------------------------------------------------
# Evaluators
# ---------------------------------------------------------------------------

def _pair(seed=0, n=3, res=32):
    rng = np.random.RandomState(seed)
    a = rng.uniform(-1, 1, (n, res, res, 3)).astype(np.float32)
    b = np.clip(a + 0.2 * rng.randn(*a.shape), -1, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("for_dataset", [None, "benchmark", "div2k"])
def test_psnr_equal_to_jax(for_dataset):
    a, b = _pair()
    got = tev.get_evaluator({"type": "psnr",
                             "args": {"for_dataset": for_dataset}})
    want = jev.get_evaluator({"type": "psnr",
                              "args": {"for_dataset": for_dataset}})
    for ev in (got, want):
        ev.add_batch(a, b)
        ev.add_batch(b, a)
        ev.set_sample_n(5)
    np.testing.assert_allclose(got.compute(), want.compute(), rtol=1e-6)


def test_psnr_of_identical_images_is_inf():
    """mse 0: -10 log10(0) = +inf, the JAX package's value."""
    a, _ = _pair()
    got, want = tev.psnr_evaluator(), jev.psnr_evaluator()
    got.add_batch(a, a)
    with np.errstate(divide="ignore"):
        want.add_batch(a, a)
    assert got.compute() == want.compute() == float("inf")


def test_ssim_lpips_compose_equal_to_jax():
    a, b = _pair(1)
    jparams = jlp.lpips_init(jax.random.PRNGKey(0))
    got = tev.compose_evaluator([tev.ssim_evaluator(),
                                 tev.lpips_evaluator(
                                     tlp.from_jax_params(jparams)),
                                 tev.null_evaluator()])
    want = jev.compose_evaluator([jev.ssim_evaluator(),
                                  jev.lpips_evaluator(jparams),
                                  jev.null_evaluator()])
    for ev in (got, want):
        ev.add_batch(a, b)
        ev.add_batch(a[:2], a[:2])
    g, w = got.compute(), want.compute()
    assert set(g) == set(w) == {"ssim", "lpips"}
    np.testing.assert_allclose(g["ssim"], w["ssim"], rtol=1e-5)
    np.testing.assert_allclose(g["lpips"], w["lpips"], rtol=1e-4)
    per = tev.ssim_nhwc(torch.from_numpy(a), torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(per, 1.0, rtol=1e-5)
    assert "ssim=" in got.one_line_summary()
    got.clear_data()
    assert got.evaluators[0].vals == []
