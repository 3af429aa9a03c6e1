"""The port's export slice on the CPU: the re-param fold against the JAX
package's, the folded kernel chain against the training generator, the
kernels as `torch.library` custom ops (`opcheck`), `torch.export` round
trips of the kernel chain and of the app pipeline (per bucket and with
dynamic H, W), the export and create_pipeline CLIs, and the reference
snapshot loader against the JAX package's on a pickle of stand-in classes.

Tolerances: fold 1e-6 per tensor (the same float32 sums in another
order); the folded chain against the training net atol 1e-4 + rtol 1e-4
and the fold statistic (rtol 1e-3) 0.0%; an exported program against the
live module it was traced from, exactly.
"""

import os
import pickle
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from torch import nn

from migan_tpu.export.fold import fold_generator as j_fold
from migan_tpu.io import checkpoint as jckpt
from migan_tpu.io import pkl_import as j_pkl
from migan_tpu.models import migan as jm
from migan_tpu_torch.cli import create_pipeline, demo
from migan_tpu_torch.cli import export as export_cli
from migan_tpu_torch.export import torch_export
from migan_tpu_torch.export.fold import (
    diff_count, fold_diff_statistic, fold_generator,
)
from migan_tpu_torch.export.pipeline import make_pipeline
from migan_tpu_torch.io import (
    export_migan_train, load_npz, load_train_npz, loads_reference_snapshot,
    save_npz,
)
from migan_tpu_torch.models import migan as tm
from migan_tpu_torch.models.migan_kernels import KernelGenerator
from migan_tpu_torch.ops.kernels import downblock, sepconv, upblock

KERNEL_OPS = {torch.ops.migan.fused_block.default,
              torch.ops.migan.fused_down_block.default,
              torch.ops.migan.fused_up_block.default}
# the shapes of tests/test_export.py's polymorphic pipeline test
POLY_SHAPES = [(160, 160), (140, 133), (65, 200), (48, 96)]


def _jax_train(res, n_tensors, tmp_path):
    """JAX training params with noise strengths 0.3 (as
    tests/test_export.py), and the port's training G of the same
    weights."""
    cfg = jm.MiganConfig(resolution=res, num_reparam_tensors=n_tensors)
    params = jm.generator_init(jax.random.PRNGKey(0), cfg)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: jnp.asarray(0.3) if p[-1].key == "noise_strength"
        else v, params)
    path = tmp_path / f"train{res}.npz"
    jckpt.save_npz(str(path), params)
    g = tm.Generator(tm.MiganConfig(resolution=res,
                                    num_reparam_tensors=n_tensors))
    g.load_state_dict(load_train_npz(str(path)), strict=True)
    return cfg, params, g.eval(), str(path)


@pytest.fixture(scope="module")
def train64(tmp_path_factory):
    return _jax_train(64, 3, tmp_path_factory.mktemp("t64"))


@pytest.fixture(scope="module")
def train32(tmp_path_factory):
    return _jax_train(32, 2, tmp_path_factory.mktemp("t32"))


def _model_input(n, res, seed=0):
    rng = np.random.RandomState(seed)
    mask = (rng.rand(n, res, res, 1) > 0.4).astype(np.float32)
    img = rng.rand(n, res, res, 3).astype(np.float32) * 2 - 1
    return np.concatenate([mask - 0.5, img * mask], axis=-1)


def _op_targets(program) -> set:
    """The ops a program calls, in its graph and in the subgraphs of its
    higher-order ops (the chain's no_grad region is one)."""
    return {n.target for m in program.graph_module.modules()
            if isinstance(m, torch.fx.GraphModule)
            for n in m.graph.nodes if n.op == "call_function"}


# ---------------------------------------------------------------------------
# the fold
# ---------------------------------------------------------------------------

def test_fold_matches_jax_tensor_by_tensor(train64):
    cfg, params, g, _ = train64
    want = jckpt._flatten(j_fold(params, cfg))
    got = fold_generator(g).state_dict()
    assert set(got) == {k.replace("/", ".") for k in want}
    for key, w in want.items():
        t = got[key.replace("/", ".")].numpy()
        if t.ndim == 4:                              # OIHW -> HWIO
            t = t.transpose(2, 3, 1, 0)
        assert t.shape == w.shape, key
        np.testing.assert_allclose(t, w, rtol=0, atol=1e-6, err_msg=key)


def test_folded_kernel_chain_reproduces_the_training_net(train64):
    """The reference's check (export_inference_model.py:132-164): the
    folded net, here through the kernel chain, against train-G in `const`
    noise mode."""
    _, _, g, _ = train64
    x = torch.from_numpy(_model_input(2, 64))
    assert fold_diff_statistic(g, x) == 0.0
    with torch.no_grad():
        want = tm.generator_apply(g, x, noise_mode="const")
        got = KernelGenerator(fold_generator(g).eval())(x)
    assert diff_count(want, got) == 0            # the statistic: 0.0%
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)
    with pytest.raises(ValueError, match="depthwise"):
        fold_generator(tm.Generator(tm.MiganConfig(
            resolution=16, depthwise=False, reparametrize=False)))


# ---------------------------------------------------------------------------
# the kernels as custom ops
# ---------------------------------------------------------------------------

def _opcheck_cases():
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g)

    c, o = 8, 16
    sep = (r(3, 3, c), r(c), r(c, o))
    x = r(2, 8, 6, c)
    return [
        ("sepconv", sepconv.fused_block_op, (x, *sep, None, True)),
        ("sepconv noise, no act", sepconv.fused_block_op,
         (x, *sep, r(8, 6), False)),
        ("downblock", downblock.fused_down_block_op, (x, *sep)),
        ("upblock feat+rgb", upblock.fused_up_block_op,
         (r(2, 4, 3, c), x, r(8, 6), *sep, r(8, 6), r(o, 3), r(3), True)),
        ("upblock rgb only", upblock.fused_up_block_op,
         (r(2, 4, 3, c), x, r(8, 6), *sep, None, r(o, 3), r(3), False)),
        ("upblock feat only", upblock.fused_up_block_op,
         (r(2, 4, 3, c), x, r(8, 6), *sep, None, None, None, True)),
    ]


@pytest.mark.parametrize("case", range(6))
def test_kernel_ops_pass_opcheck(case):
    """`torch.library.opcheck` with CPU tensors, where the op runs its
    plain version. Of its checks, test_schema (no input mutated or
    aliased by an output) and test_faketensor (the fake implementation's
    shapes, dtypes and devices equal the real one's) apply in full;
    test_aot_dispatch_dynamic traces the forward with dynamic shapes. The
    ops have no autograd formula (the chain runs without gradients) and
    no input requires grad here, so test_autograd_registration and the
    backward half of test_aot_dispatch_dynamic check nothing."""
    name, op, args = _opcheck_cases()[case]
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, (name, result)


def test_wrappers_call_the_custom_ops():
    """The public wrappers return what their arguments ask for from
    upblock's fixed (features, rgb) pair, and go through the ops where
    `torch.export` traces them."""
    name, op, args = _opcheck_cases()[3]
    x_lo, skip, n1, w_dw, b_dw, w_pw, n2, w_rgb, b_rgb, _ = args
    feat, rgb = upblock.fused_up_block(x_lo, skip, n1, w_dw, b_dw, w_pw, n2,
                                       w_rgb, b_rgb)
    want_f, want_rgb = upblock.upblock_plain(x_lo, skip, n1, w_dw, b_dw,
                                             w_pw, n2, w_rgb, b_rgb)
    assert torch.equal(feat, want_f) and torch.equal(rgb, want_rgb)
    only = upblock.fused_up_block(x_lo, skip, n1, w_dw, b_dw, w_pw, n2,
                                  w_rgb, b_rgb, emit_features=False)
    assert torch.equal(only, want_rgb)
    plain = upblock.fused_up_block(x_lo, skip, n1, w_dw, b_dw, w_pw)
    assert plain.shape == feat.shape
    traced = torch.export.export(_UpOnly(), (x_lo, skip, n1))
    assert KERNEL_OPS & _op_targets(traced) == {
        torch.ops.migan.fused_up_block.default}


class _UpOnly(nn.Module):
    def forward(self, x_lo, skip, n1):
        c = x_lo.shape[-1]
        w = torch.ones(3, 3, c), torch.zeros(c), torch.eye(c)
        return upblock.fused_up_block(x_lo, skip, n1, *w)


# ---------------------------------------------------------------------------
# torch.export of the kernel chain and the CLIs
# ---------------------------------------------------------------------------

def test_kernel_chain_export_round_trip(train32, tmp_path):
    """`load_model`'s forward exported, saved, loaded in this process:
    the program holds the three kernel ops and equals the live chain
    exactly."""
    _, _, g, _ = train32
    save_npz(str(tmp_path / "w.npz"), fold_generator(g))
    forward, res = demo.load_model("migan-32", str(tmp_path / "w.npz"),
                                   device="cpu")
    x = torch.from_numpy(_model_input(1, res, seed=1))
    program = torch_export.save(str(tmp_path / "m.pt2"), forward, [x])
    assert KERNEL_OPS <= _op_targets(program)
    loaded = torch_export.load(str(tmp_path / "m.pt2"))
    got, want = loaded(x), forward(x)
    assert (got - want).abs().max().item() == 0.0


class _StandIn(nn.Module):
    """A reference class that the loaders must not need: pickled under a
    module path that is removed before loading."""


def _stand_in(state: dict) -> nn.Module:
    """A tree of stand-in modules whose state_dict is `state`
    (noise_const and resample_filter as buffers, as in the reference)."""
    root = _StandIn()
    for key, v in state.items():
        *path, leaf = key.split(".")
        m = root
        for p in path:
            if p not in m._modules:
                m.add_module(p, _StandIn())
            m = m._modules[p]
        t = torch.as_tensor(np.array(v))
        if leaf in ("noise_const", "resample_filter"):
            m.register_buffer(leaf, t)
        else:
            m.register_parameter(leaf, nn.Parameter(t, requires_grad=False))
    return root


def _reference_snapshot(g: tm.Generator) -> bytes:
    """A reference-style `network-snapshot-*.pkl` of G, D and G_ema (the
    G weights, with resample_filter buffers), plus a
    persistence-pickled entry, pickled from stand-in classes of
    `lib.model_zoo.migan` and `torch_utils.persistence` that exist only
    while pickling."""
    names = ("lib", "lib.model_zoo", "lib.model_zoo.migan", "torch_utils",
             "torch_utils.persistence")
    mods = {n: types.ModuleType(n) for n in names}

    def _reconstruct_persistent_obj(meta):
        raise AssertionError("the embedded class code must not run")

    _reconstruct_persistent_obj.__module__ = "torch_utils.persistence"
    _reconstruct_persistent_obj.__qualname__ = "_reconstruct_persistent_obj"
    mods["torch_utils.persistence"]._reconstruct_persistent_obj = \
        _reconstruct_persistent_obj
    mods["lib.model_zoo.migan"]._StandIn = _StandIn
    ref = export_migan_train(g.state_dict())
    ref["synthesis.b8.conv1.conv2.resample_filter"] = np.ones((4, 4),
                                                              np.float32)
    d_cfg = tm.MiganConfig(resolution=16, num_reparam_tensors=2)
    d = tm.init_weights(tm.Discriminator(d_cfg),
                        torch.Generator().manual_seed(1))

    class _Persistent:
        def __init__(self, module):
            self.meta = {"type": "class", "version": 4, "module_src": "",
                         "class_name": "Tiny",
                         "state": dict(module.__dict__)}

        def __reduce__(self):
            return _reconstruct_persistent_obj, (self.meta,)

    tiny = _stand_in({"conv.weight": np.ones((2, 3, 1, 1), np.float32),
                      "buf": np.arange(4, dtype=np.float32)})
    saved = {n: sys.modules.get(n) for n in names}
    old_module = _StandIn.__module__
    _StandIn.__module__ = "lib.model_zoo.migan"
    sys.modules.update(mods)
    try:
        blob = pickle.dumps({"G": _stand_in(ref), "D": _stand_in(
            export_migan_train(d.state_dict())), "G_ema": _stand_in(ref),
            "extra": _Persistent(tiny), "none": None})
    finally:
        _StandIn.__module__ = old_module
        for n, m in saved.items():
            if m is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = m
    assert "lib.model_zoo.migan" not in sys.modules
    return blob


def test_snapshot_loader_matches_jax(train32):
    _, _, g, _ = train32
    blob = _reference_snapshot(g)
    got = loads_reference_snapshot(blob)
    want = j_pkl.loads_reference_snapshot(blob)
    assert set(got) == set(want) == {"G", "D", "G_ema", "extra", "none"}
    assert got["none"] is None and want["none"] is None
    for name in ("G", "D", "G_ema", "extra"):
        assert set(got[name]) == set(want[name]), name
        for k, v in want[name].items():
            np.testing.assert_array_equal(got[name][k], v, err_msg=k)
    assert "w1" in {k.split(".")[-1] for k in got["G_ema"]}
    np.testing.assert_array_equal(got["extra"]["buf"], np.arange(4))


def _sample_files(tmp_path, res=32, n=2):
    images, masks = tmp_path / "images", tmp_path / "masks"
    images.mkdir()
    masks.mkdir()
    rng = np.random.RandomState(0)
    for i in range(n):
        Image.fromarray(rng.randint(0, 256, (40 + i, 48, 3),
                                    np.uint8)).save(images / f"{i}.png")
        m = np.full((40 + i, 48), 255, np.uint8)
        m[8:24, 10:30] = 0
        Image.fromarray(m).save(masks / f"{i}.png")
    return images, masks


@pytest.mark.parametrize("kind", ["npz", "pt", "pkl"])
def test_export_cli(kind, train32, tmp_path):
    """Each input kind gives the same folded weights, a `.pt2` of the
    kernel chain that equals the live chain, composites, a fold
    statistic of 0.0% and, through the chain's plain versions, one
    within the JAX package's bound."""
    _, _, g, npz_path = train32
    if kind == "npz":
        path = npz_path
    elif kind == "pt":
        path = str(tmp_path / "g.pt")
        torch.save({k: torch.from_numpy(v)
                    for k, v in export_migan_train(g.state_dict()).items()},
                   path)
    else:
        path = str(tmp_path / "network-snapshot-000042.pkl")
        with open(path, "wb") as f:
            f.write(_reference_snapshot(g))
    images, masks = _sample_files(tmp_path)
    out = tmp_path / "out"
    stats = export_cli.main(["--model-path", path, "--resolution", "32",
                             "--num-reparam-tensors", "2", "--origs-dir",
                             str(images), "--masks-dir", str(masks),
                             "--output-dir", str(out), "--num-samples", "1",
                             "--device", "cpu"])
    assert stats["diff_pct"] == 0.0
    assert stats["chain_diff_pct"] < 0.5          # the JAX package's bound
    assert stats["chain_max_abs_diff"] <= 1e-4
    folded = load_npz(str(out / "models" / "migan.npz"))
    want = fold_generator(g).state_dict()
    for k, v in folded.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0)
    program = torch.export.load(str(out / "models" / "migan.pt2"))
    assert KERNEL_OPS <= _op_targets(program)
    x = torch.from_numpy(_model_input(1, 32, seed=2))
    live = KernelGenerator(folded.eval())(x)
    assert (program.module()(x) - live).abs().max().item() == 0.0
    for sub in ("original_result", "converted_result"):
        assert os.listdir(out / "samples" / sub) == ["0.png"]


def test_export_cli_refuses_a_directory(tmp_path):
    """A checkpoint directory that is not the port's (here laid out as the
    JAX package's orbax TrainState) is refused with the reason; the port's
    own checkpoint directory is read (tests/test_torch_train_loop.py)."""
    ckpt = tmp_path / "weight" / "step_00000002"
    ckpt.mkdir(parents=True)
    (ckpt / "_CHECKPOINT_METADATA").write_text("{}")
    for path in (ckpt, ckpt.parent):
        with pytest.raises(SystemExit, match="orbax"):
            export_cli.main(["--model-path", str(path), "--resolution",
                             "32", "--origs-dir", str(tmp_path),
                             "--masks-dir", str(tmp_path), "--output-dir",
                             str(tmp_path / "o"), "--device", "cpu"])


def test_create_pipeline_cli(train32, tmp_path):
    """One `.pt2` per bucket and a dynamic one; the dynamic program equals
    the live pipeline bit for bit at the four shapes of
    tests/test_export.py, and each bucket's program at its bucket."""
    _, _, g, _ = train32
    weights = str(tmp_path / "w.npz")
    save_npz(weights, fold_generator(g))
    images, masks = _sample_files(tmp_path)
    out = tmp_path / "out"
    written = create_pipeline.main([
        "--resolution", "32", "--model-path", weights, "--images-dir",
        str(images), "--masks-dir", str(masks), "--output-dir", str(out),
        "--device", "cpu", "--buckets", "96,160", "--polymorphic"])
    assert set(written) == {"96", "160", "dynamic"}
    assert sorted(os.listdir(out / "sample_results")) == ["0.png", "1.png"]
    forward, _ = demo.load_model("migan-32", weights, device="cpu")
    live = make_pipeline(forward, 32, device="cpu")
    dynamic = torch_export.load(written["dynamic"])
    for h, w in POLY_SHAPES:
        rng = np.random.RandomState(h)
        i = torch.from_numpy(rng.randint(0, 255, (1, h, w, 3)).astype(
            np.uint8))
        m = torch.full((1, h, w, 1), 255, dtype=torch.uint8)
        m[0, 20:40, 30:60] = 0
        assert torch.equal(dynamic(i, m), live(i, m)), (h, w)
    for b in (96, 160):
        i = torch.zeros(1, b, b, 3, dtype=torch.uint8)
        i[0, :40, :48] = torch.from_numpy(np.array(Image.open(
            images / "0.png")))
        m = torch.full((1, b, b, 1), 255, dtype=torch.uint8)
        m[0, 8:24, 10:30] = 0
        program = torch_export.load(written[str(b)])
        assert torch.equal(program(i, m), live(i, m)), b
