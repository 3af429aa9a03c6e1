"""The port's evaluation modules against the JAX package's on the CPU.

- Inception, pytorch_fid flavor: 299 without resize, 256 and 512 through
  the resize (antialiased at 512, as `jax.image.resize` is); rtol 1e-3 /
  atol 1e-4, as tests/test_detector_parity.py. Both importers take the
  same seeded state_dict (tests/torch_oracles.py).
- LPIPS per image, rtol 1e-5 / atol 1e-7 (test_detector_parity.py's).
- bf16 detectors within tests/test_evalx.py's bounds of float32 (LPIPS
  relative error < 2e-3, Inception feature L2 relative error < 3e-2).
- The FID copy, the masks, the loader and its per-item RNG give what the
  JAX package's give; `from_jax_params` round-trips.
- The seeded detector weights of the smoke runs see a wrong composite.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from migan_tpu.data import masks as j_masks, sampler as j_sampler
from migan_tpu.evalx import fid as j_fid, inception as j_inc, lpips as j_lp
from migan_tpu_torch.data import masks, sampler
from migan_tpu_torch.evalx import fid, inception, lpips
from torch_oracles import (
    TorchFIDInception, TorchLPIPSAlex, randomize_inception_,
    randomize_lpips_,
)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _sd(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def fid_inception():
    sd = _sd(randomize_inception_(TorchFIDInception(), seed=0))
    return j_inc.import_inception_state_dict(sd), \
        inception.import_inception_state_dict(sd)


@pytest.mark.parametrize("res", [299, 256, 512])
def test_inception_matches_jax(fid_inception, res):
    """At 299 no resize; at 256 the resize enlarges; at 512 it shrinks,
    with the antialiasing of jax.image.resize."""
    params, model = fid_inception
    x = np.random.RandomState(res).rand(2, res, res, 3).astype(np.float32)
    resize = res != 299
    want = np.asarray(j_inc.inception_apply(params, jnp.asarray(x),
                                            resize_input=resize))
    got = inception.inception_apply(model, torch.from_numpy(x),
                                    resize_input=resize).numpy()
    assert got.shape == (2, 2048)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_lpips_matches_jax_per_image():
    sd = _sd(randomize_lpips_(TorchLPIPSAlex(), seed=0))
    params = j_lp.import_lpips_state_dict(sd)
    model = lpips.import_lpips_state_dict(sd)
    rng = np.random.RandomState(2)
    a = rng.rand(3, 64, 64, 3).astype(np.float32)
    b = rng.rand(3, 64, 64, 3).astype(np.float32)
    want = np.asarray(j_lp.lpips_apply(params, jnp.asarray(a),
                                       jnp.asarray(b)))
    got = model(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == (3,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    same = model(torch.from_numpy(a), torch.from_numpy(a))
    np.testing.assert_allclose(same.numpy(), 0.0, atol=1e-6)


@pytest.fixture(scope="module")
def jax_init_inception():
    """`inception_init(PRNGKey(0))` of the JAX package (slow to draw)."""
    return j_inc.inception_init(jax.random.PRNGKey(0))


@pytest.mark.parametrize("res", [64, 256, 512])
def test_detector_bf16_within_jax_bound(jax_init_inception, res):
    """bf16 detectors against float32 on the same weights (the JAX
    package's random init), within test_detector_bf16_tolerance's bounds;
    at 256 and 512 the Inception resize runs in bf16 too."""
    inc = inception.from_jax_params(jax_init_inception)
    rng = np.random.RandomState(res)
    a = torch.from_numpy(rng.rand(2, res, res, 3).astype(np.float32))
    f32 = inception.inception_apply(inc, a).numpy()
    f16 = inception.inception_apply(inc, a,
                                    compute_dtype=torch.bfloat16).numpy()
    l2_rel = (np.linalg.norm(f16 - f32, axis=1)
              / np.linalg.norm(f32, axis=1))
    assert l2_rel.max() < 3e-2, l2_rel
    if res != 64:
        return
    lp = lpips.from_jax_params(j_lp.lpips_init(jax.random.PRNGKey(1)))
    b = (a + 0.1 * torch.from_numpy(rng.randn(*a.shape).astype(
        np.float32))).clamp(0, 1)
    l32 = lp(a, b).numpy()
    l16 = lp(a, b, compute_dtype=torch.bfloat16).numpy()
    rel = np.abs(l16 - l32) / (np.abs(l32) + 1e-9)
    assert rel.max() < 2e-3, rel


def _assert_tree_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _assert_tree_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def test_from_jax_params_round_trips(jax_init_inception):
    """JAX params -> the port's module -> JAX params is the identity, and
    the module computes what the JAX function computes on them."""
    j_params = jax_init_inception
    model = inception.from_jax_params(j_params)
    _assert_tree_equal(model.jax_params(), j_params)
    x = np.random.RandomState(5).rand(1, 80, 80, 3).astype(np.float32)
    np.testing.assert_allclose(
        inception.inception_apply(model, torch.from_numpy(x)).numpy(),
        np.asarray(j_inc.inception_apply(j_params, jnp.asarray(x))),
        rtol=1e-3, atol=1e-4)

    l_params = j_lp.lpips_init(jax.random.PRNGKey(6))
    lp = lpips.from_jax_params(l_params)
    _assert_tree_equal(lp.jax_params(), l_params)
    # and back: the port's own init and seeded state_dict load both ways
    for m in (lpips.lpips_init(3),
              lpips.import_lpips_state_dict(lpips.seeded_state_dict(3))):
        again = lpips.from_jax_params(m.jax_params())
        for (k, v), w in zip(m.state_dict().items(),
                             again.state_dict().values()):
            torch.testing.assert_close(v, w, rtol=0, atol=0, msg=k)
    model = inception.import_inception_state_dict(
        inception.seeded_state_dict(4))
    _assert_tree_equal(inception.from_jax_params(
        model.jax_params()).jax_params(), model.jax_params())


def test_seeded_state_dicts_load_into_the_jax_importers():
    """The port's seeded detector state_dicts use the key names that the
    JAX package's importers read, and both sides fold them alike."""
    sd = {k: v.numpy() for k, v in inception.seeded_state_dict(2).items()}
    _assert_tree_equal(
        inception.import_inception_state_dict(sd).jax_params(),
        j_inc.import_inception_state_dict(sd))
    sd = {k: v.numpy() for k, v in lpips.seeded_state_dict(2).items()}
    _assert_tree_equal(lpips.import_lpips_state_dict(sd).jax_params(),
                       j_lp.import_lpips_state_dict(sd))


def test_seeded_inception_sees_a_wrong_composite():
    """The smoke runs hold the card's Inception activations to the CPU's
    at 1e-3 relative L2. With `seeded_state_dict` that hold must see a
    wrong composite: noise in place of a hole of a ninth of the image
    moves an image's activations by more than 50x that (about 0.3 at
    299; with BatchNorm statistics drawn at random instead of calibrated,
    about 1e-4, which the hold could not see)."""
    model = inception.import_inception_state_dict(
        {k: v.numpy() for k, v in inception.seeded_state_dict(0).items()})
    rng = np.random.RandomState(0)
    a = rng.rand(2, 299, 299, 3).astype(np.float32)
    b = a.copy()
    b[:, 100:200, 100:200] = rng.rand(2, 100, 100, 3)
    fa, fb = (inception.inception_apply(model, torch.from_numpy(v),
                                        resize_input=False).numpy()
              for v in (a, b))
    rel = np.linalg.norm(fb - fa, axis=1) / np.linalg.norm(fa, axis=1)
    assert rel.min() > 5e-2, rel


def test_seeded_inception_features_keep_their_scale_at_512():
    """What the smoke runs feed `seeded_state_dict`'s weights, 512² noise
    and composites with a smooth fill, gives pool features of the scale
    real ones have (FID's `sqrtm` is then well-conditioned; unscaled they
    averaged ~30 and reached ~400), and the fill moves them by more than
    50x the 1e-3 hold."""
    model = inception.import_inception_state_dict(
        {k: v.numpy() for k, v in inception.seeded_state_dict(0).items()})
    rng = np.random.RandomState(1)
    a = rng.rand(2, 512, 512, 3).astype(np.float32)
    b = a.copy()
    lo = torch.from_numpy(rng.rand(2, 3, 16, 16).astype(np.float32))
    smooth = torch.nn.functional.interpolate(
        lo, size=(200, 200), mode="bilinear").permute(0, 2, 3, 1).numpy()
    b[:, 100:300, 150:350] = smooth
    fa, fb = (inception.inception_apply(model, torch.from_numpy(v)).numpy()
              for v in (a, b))
    assert max(fa.mean(), fb.mean()) < 1.0, (fa.mean(), fb.mean())
    assert max(fa.max(), fb.max()) < 10.0, (fa.max(), fb.max())
    rel = np.linalg.norm(fb - fa, axis=1) / np.linalg.norm(fa, axis=1)
    assert rel.min() > 5e-2, rel


def test_fid_copy_equals_jax_package():
    rng = np.random.RandomState(0)
    real = rng.randn(64, 16)
    fake = rng.randn(48, 16) * 1.3 + 0.2
    assert fid.fid_from_feature_arrays(real, fake) == pytest.approx(
        j_fid.fid_from_feature_arrays(real, fake), rel=1e-12)
    mu, sig = real.mean(0), np.cov(real, rowvar=False)
    assert fid.frechet_distance(mu, sig, mu, sig) == pytest.approx(
        j_fid.frechet_distance(mu, sig, mu, sig), abs=1e-9)


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
@pytest.mark.parametrize("size,hole_range", [(64, (0, 1)), (256, (0, 1)),
                                             (128, (0.2, 0.6))])
def test_masks_bit_equal(seed, size, hole_range):
    got = masks.random_mask_uint8(size, hole_range,
                                  rng=np.random.RandomState(seed))
    want = j_masks.random_mask_uint8(size, hole_range,
                                     rng=np.random.RandomState(seed))
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_masks_global_stream_bit_equal():
    np.random.seed(3)
    got = [masks.random_mask_uint8(64) for _ in range(3)]
    np.random.seed(3)
    want = [j_masks.random_mask_uint8(64) for _ in range(3)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


class _Draws:
    """A dataset whose items draw from the RNG the loader hands them."""

    supports_rng = True

    def __len__(self):
        return 11

    def __getitem__(self, i, rng=None):
        r = np.random if rng is None else rng
        return (np.full((2,), i, np.float32), r.rand(3), int(i), f"n{i}",
                [i])


@pytest.mark.parametrize("seed,workers", [(None, 1), (5, 1), (5, 3)])
def test_dataloader_batches_equal(seed, workers):
    kw = dict(batch_size=4, indices=range(10), num_workers=workers,
              drop_last=False, seed=seed)
    np.random.seed(0)
    got = list(sampler.DataLoader(_Draws(), **kw))
    np.random.seed(0)
    want = list(j_sampler.DataLoader(_Draws(), **kw))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert len(g) == len(w) == 5
        for a, b in zip(g, w):
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b


def test_sampler_and_item_rng_equal():
    for seed, pos in ((0, 0), (5, 17), (2 ** 31, 12345)):
        np.testing.assert_array_equal(
            sampler._item_rng(seed, pos).rand(4),
            j_sampler._item_rng(seed, pos).rand(4))


def test_torch_state_dict_reader_equals_jax_package(tmp_path):
    from migan_tpu.io.torch_import import load_torch_state_dict as j_load
    from migan_tpu_torch.io import load_torch_state_dict

    path = tmp_path / "lp.pth"
    torch.save(lpips.seeded_state_dict(1), path)
    got, want = load_torch_state_dict(str(path)), j_load(str(path))
    assert list(got) == list(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("res", [256, 512])
def test_inception_resize_against_pytorch_fid_resize(res):
    """The JAX package's Inception resize (`jax.image.resize`, "bilinear",
    antialiased by default), which the port follows: at 256 (it enlarges)
    it is pytorch_fid's F.interpolate(bilinear, align_corners=False); at
    512 (it shrinks) it is not, but F.interpolate(..., antialias=True)."""
    import torch.nn.functional as F

    from migan_tpu_torch.ops.resize import resize_bilinear

    x = torch.from_numpy(np.random.RandomState(res).rand(
        2, res, res, 3).astype(np.float32))
    want_jax = np.asarray(jax.image.resize(jnp.asarray(x.numpy()),
                                           (2, 299, 299, 3), "bilinear"))
    got = resize_bilinear(x, (299, 299))
    np.testing.assert_allclose(got.numpy(), want_jax, atol=1e-5)
    nchw = x.permute(0, 3, 1, 2)
    plain, aa = (F.interpolate(nchw, size=(299, 299), mode="bilinear",
                               align_corners=False, antialias=a)
                 .permute(0, 2, 3, 1) for a in (False, True))
    d_plain = float((got - plain).abs().max())
    d_aa = float((got - aa).abs().max())
    print(f"res {res}: max |diff| to pytorch_fid's resize {d_plain:.3e}, "
          f"to the antialiased resize {d_aa:.3e}")
    if res == 256:
        assert d_plain < 1e-5
    else:
        assert d_plain > 0.1 and d_aa < 1e-4
