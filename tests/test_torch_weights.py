"""The port's weight bridge (`migan_tpu_torch.io`): the JAX package's .npz and
the reference .pt state_dict (made here by
`migan_tpu.io.export_migan_inference`) give identical tensors, in torch's
layout; the port's `save_npz` writes what `migan_tpu` reads back."""

import numpy as np
import jax
import torch

from migan_tpu.io import export_migan_inference
from migan_tpu.io.checkpoint import load_npz as j_load_npz
from migan_tpu.io.checkpoint import save_npz as j_save_npz
from migan_tpu.models.migan_inference import (
    GeneratorConfig as JConfig, generator_init as j_init,
)
from migan_tpu_torch.io import load_npz, load_pt, load_weights, save_npz
from migan_tpu_torch.models.migan_inference import GeneratorConfig

RES, CH_BASE = 64, 4096


def _jax_params():
    return j_init(jax.random.PRNGKey(1), JConfig(resolution=RES,
                                                 ch_base=CH_BASE))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict)
                   else {key: np.asarray(v)})
    return out


def _cfg():
    return GeneratorConfig(resolution=RES, ch_base=CH_BASE)


def test_npz_bridge_layouts(tmp_path):
    params = _jax_params()
    path = str(tmp_path / "w.npz")
    j_save_npz(path, params)
    g = load_npz(path, _cfg())
    sd = g.state_dict()
    flat = _flat(params)
    assert set(sd) == set(flat)
    for key, v in flat.items():
        want = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v   # HWIO->OIHW
        np.testing.assert_array_equal(sd[key].numpy(), want, err_msg=key)
    # depthwise [3,3,1,C] -> [C,1,3,3]; pointwise [1,1,C,O] -> [O,C,1,1]
    assert tuple(sd["encoder.b64.conv1.conv1.weight"].shape) == (64, 1, 3, 3)
    assert tuple(sd["encoder.b64.conv2.conv2.weight"].shape) == (128, 64, 1,
                                                                 1)


def test_pt_and_npz_give_identical_tensors(tmp_path):
    params = _jax_params()
    npz = str(tmp_path / "w.npz")
    j_save_npz(npz, params)
    sd = {k: torch.from_numpy(np.array(v))
          for k, v in export_migan_inference(params).items()}
    # the reference also carries fixed resampling buffers, which are dropped
    sd["encoder.b64.conv2.filter.weight"] = torch.ones(64, 1, 4, 4)
    sd["synthesis.b8.conv1.filter_const"] = torch.ones(8, 8)
    pt = str(tmp_path / "w.pt")
    torch.save(sd, pt)
    a = load_npz(npz, _cfg()).state_dict()
    b = load_weights(pt, _cfg()).state_dict()
    c = load_pt(torch.load(pt, weights_only=True), _cfg()).state_dict()
    assert set(a) == set(b) == set(c)
    for k in a:
        assert torch.equal(a[k], b[k]) and torch.equal(a[k], c[k]), k


def test_save_npz_round_trips_through_jax(tmp_path):
    params = _jax_params()
    src = str(tmp_path / "src.npz")
    j_save_npz(src, params)
    out = str(tmp_path / "out.npz")
    save_npz(out, load_npz(src, _cfg()))
    back = _flat(j_load_npz(out))
    for key, v in _flat(params).items():
        np.testing.assert_array_equal(back[key], v, err_msg=key)


def test_config_inferred_from_weights(tmp_path):
    path = str(tmp_path / "w.npz")
    j_save_npz(path, j_init(jax.random.PRNGKey(0), JConfig(resolution=32)))
    assert load_npz(path).cfg == GeneratorConfig(resolution=32)
