"""The port's config banks, model registry and training data
(`utils/config.py`, `models/registry.py`, `data/factory.py`,
`data/ds_places2.py`, `data/sampler.py`) against the JAX package on the
CPU: every experiment resolves to the same dict; every model of the
banks that the JAX registry builds has the JAX parameter count (the port
on the meta device, JAX by `jax.eval_shape`); the Places2 dataset with
`FreeFormMaskFormatter` and the `InfiniteSampler` give bit-equal streams
for the same seed, on seeded PNGs written here; the loader's
`start_position` continues a stream; `mask_backend: native` raises.
All comparisons exact.
"""

import os

import jax
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from migan_tpu.data import factory as jfactory
from migan_tpu.data import sampler as jsampler
from migan_tpu.models import registry as jregistry
from migan_tpu.utils import config as jconfig
from migan_tpu_torch.data import factory as tfactory
from migan_tpu_torch.data import sampler as tsampler
from migan_tpu_torch.models import registry as tregistry
from migan_tpu_torch.utils import config as tconfig


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The gate runs 6 test workers on one host: torch's default of one
    thread per core in each of them oversubscribes it several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")


def _names(kind):
    out = []
    for f in sorted(os.listdir(os.path.join(CONFIGS, kind))):
        if f.endswith(".yaml"):
            with open(os.path.join(CONFIGS, kind, f)) as fh:
                out += [k for k, v in yaml.safe_load(fh).items()
                        if isinstance(v, dict)]
    return out


EXPERIMENTS = sorted(f[:-5] for f in os.listdir(os.path.join(
    CONFIGS, "experiment")) if f.endswith(".yaml"))


@pytest.mark.parametrize("name", EXPERIMENTS)
def test_experiment_resolves_as_in_jax(name):
    want = jconfig.ConfigBanks(CONFIGS).experiment(name)
    got = tconfig.ConfigBanks(CONFIGS).experiment(name)
    assert got == want


def test_config_helpers_match_jax():
    """apply_overrides, split_batch and cfg_to_debug on the same input."""
    sets = ["train.g_opt_kwargs.lr=1e-4", "train.g_opt_kwargs.betas.1=0.5",
            "train.batch_size=8", "train.new_section.flag=true",
            "env.rnd_seed=7", "train.metrics=[]"]
    got, want = ({"train": {"g_opt_kwargs": {"lr": 1e-3,
                                             "betas": [0.0, 0.99]},
                            "batch_size": 32}} for _ in range(2))
    assert tconfig.apply_overrides(got, sets) == \
        jconfig.apply_overrides(want, sets)
    with pytest.raises(ValueError):
        tconfig.apply_overrides(got, ["no_equals_sign"])
    for sec in ({"batch_size": 32}, {"batch_size_per_device": 2}):
        a, b = dict(sec), dict(sec)
        tconfig.split_batch(a, 1)
        jconfig.split_batch(b, 1)
        assert a == b
    cfg = tconfig.ConfigBanks(CONFIGS).experiment("migan_places256")
    assert tconfig.cfg_to_debug(cfg) == jconfig.cfg_to_debug(
        jconfig.ConfigBanks(CONFIGS).experiment("migan_places256"))


def _jax_count(handle) -> int:
    shapes = jax.eval_shape(handle.init, jax.random.PRNGKey(0))
    return sum(int(np.prod(s.shape)) for s in
               jax.tree_util.tree_leaves(shapes))


def _buildable(name) -> bool:
    """The JAX registry builds it. (The stylegan2_* entries of
    comodgan.yaml are routed by their prefix to a stylegan.yaml the banks
    do not have, in both packages, and are left out.)"""
    try:
        cfg = jconfig.ConfigBanks(CONFIGS).model(name)
    except FileNotFoundError:
        return False
    return cfg["type"] in jregistry._MODELS


MODELS = [n for n in _names("model") if _buildable(n)]


@pytest.mark.parametrize("name", MODELS)
def test_model_bank_counts_match_jax(name):
    """Every model of configs/model/ that the JAX registry builds: the
    port's module (on the meta device, buffers included) has the JAX
    params' element count."""
    want = _jax_count(jregistry.get_model()(
        jconfig.ConfigBanks(CONFIGS).model(name)))
    handle = tregistry.get_model()(tconfig.ConfigBanks(CONFIGS).model(name))
    with torch.device("meta"):
        module = handle.init(torch.Generator())
    assert tregistry.count_params(module) == want


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def places2_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("places2")
    d = root / "train_256" / "a"
    d.mkdir(parents=True)
    rng = np.random.RandomState(0)
    for i in range(6):
        Image.fromarray(rng.randint(0, 255, (70, 60, 3), np.uint8)).save(
            d / f"img{i}.png")
    return str(root)


def _places_cfg(root, res=32, **extra):
    return {"type": "places2", "root_dir": root, "mode": "train256",
            "loader": [{"type": "DefaultLoader", "args": {}}],
            "formatter": {"type": "FreeFormMaskFormatter",
                          "args": {"resolution": res, "random_flip": True,
                                   "hole_range": [0.0, 1.0], **extra}}}


@pytest.mark.parametrize("cache", [False, True])
def test_freeform_dataset_bit_equal_to_jax(places2_dir, cache):
    """Each item (bicubic resize, flip, RandomMask) for the same per-item
    RNG, over two passes (the second from the cache when cache_decoded)."""
    cfg = dict(_places_cfg(places2_dir), cache_decoded=cache)
    want_ds, got_ds = jfactory.get_dataset(cfg), tfactory.get_dataset(cfg)
    assert len(got_ds) == len(want_ds) == 6
    for pos in range(12):
        x, m, uid = got_ds.__getitem__(pos % 6,
                                       rng=tsampler._item_rng(5, pos))
        xw, mw, uw = want_ds.__getitem__(pos % 6,
                                         rng=jsampler._item_rng(5, pos))
        assert uid == uw and x.dtype == np.float32
        np.testing.assert_array_equal(x, xw)
        np.testing.assert_array_equal(m, mw)


@pytest.mark.parametrize("block", [1, 4])
def test_infinite_sampler_bit_equal_to_jax(block):
    """The JAX sampler's single-process stream, whatever its block."""
    got = iter(tsampler.InfiniteSampler(7, seed=3))
    want = iter(jsampler.InfiniteSampler(7, seed=3, block=block))
    assert [next(got) for _ in range(30)] == [next(want) for _ in range(30)]


def test_loader_start_position_continues_the_stream(places2_dir):
    """A loader started at item position 8 (its indices fast-forwarded
    as the trainer does) yields the uninterrupted loader's batches from
    the third on, bit for bit, and the JAX loader's."""
    def batches(ds, start, workers, loader=tsampler.DataLoader,
                sampler=tsampler.InfiniteSampler):
        it = iter(sampler(len(ds), seed=1))
        for _ in range(start):
            next(it)
        out = []
        for i, b in enumerate(loader(ds, 4, indices=it, num_workers=workers,
                                     seed=9, start_position=start)):
            out.append(b)
            if i == 3 - start // 4:
                return out

    ds = tfactory.get_dataset(_places_cfg(places2_dir))
    straight = batches(ds, 0, 1)
    resumed = batches(ds, 8, 3)
    jax_stream = batches(jfactory.get_dataset(_places_cfg(places2_dir)), 0,
                         2, jsampler.DataLoader, jsampler.InfiniteSampler)
    for a, b in zip(straight[2:], resumed):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    for a, b in zip(straight, jax_stream):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_native_mask_backend_raises(places2_dir):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tfactory.get_dataset(_places_cfg(places2_dir, mask_backend="native"))


def test_unknown_dataset_type_raises():
    with pytest.raises(NotImplementedError, match="FFHQ"):
        tfactory.get_dataset({"type": "ffhq", "root_dir": "x"})
