"""Co-Mod-GAN through the demo CLI's `load_model` on the CPU, held to the
benchmark's plain reference (`portbench/reference/comodgan.py`) on the
reference's seeded weights, in the reproducible mode the benchmark cell
runs (one latent from `z_npy`, constant noise): the images at small
widths, the spans and counters of the entry and the generator, and the
checkpoint's names at the published 512 widths."""

import math

import numpy as np
import pytest
import torch

from migan_tpu_torch.cli.demo import ModelForward, load_model
from migan_tpu_torch.models.comodgan import CoModGANConfig, CoModGANGenerator
from migan_tpu_torch.utils import tracing
from portbench.reference import comodgan as ref
from portbench.reference import comodgan_work

PUBLISHED = dict(resolution=512, ch_base=32768, ch_max=512, ic_n=4, rgb_n=3,
                 z_dim=512, w_dim=512, w0_dim=1024, mapping_layers=8)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The gate runs 6 test workers on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(res, ch_base, ch_max):
    return dict(PUBLISHED, resolution=res, ch_base=ch_base, ch_max=ch_max)


def _model(tmp_path, cfg, seed=2 ** 33 + 5):
    """(load_model's forward, the reference's state, z [1, z_dim])."""
    state = ref.seeded_state(cfg, seed, "cpu")
    torch.save(state, tmp_path / "w.pt")
    z = np.random.default_rng(seed).standard_normal((1, 512)).astype(
        np.float32)
    np.save(tmp_path / "z.npy", z)
    forward, res = load_model(f"comodgan-{cfg['resolution']}",
                              str(tmp_path / "w.pt"), "float32", "cpu",
                              ch_base=cfg["ch_base"], ch_max=cfg["ch_max"],
                              z_npy=str(tmp_path / "z.npy"),
                              noise_mode="const")
    assert res == cfg["resolution"]
    return forward, state, torch.from_numpy(z)


def _inputs(n, res, seed):
    """[n, res, res, 4] model inputs with a rectangular hole each."""
    g = torch.Generator().manual_seed(seed)
    rgb = torch.rand(n, res, res, 3, generator=g) * 2 - 1
    mask = torch.ones(n, res, res, 1)
    for i in range(n):
        a = res // 8 + i
        mask[i, a:a + res // 3, res // 4:res // 2 + i] = 0
    return torch.cat([mask - 0.5, rgb * mask], dim=-1)


# (resolution, ch_base, ch_max, batch): every width the same, a batch of
# 2 with holes; then widths that change at every level (ch 4 at 64 up to
# 32 at 8 and 4), so each up-2 conv changes its width, one image.
CASES = {"batch2_holes": (64, 2048, 32, 2),
         "widths_change_every_up2": (64, 256, 32, 1)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_load_model_matches_the_plain_reference(tmp_path, case):
    """Tolerances: float32 on both sides, the same mathematics in other
    formulations (activations scaled by the styles and one shared conv
    against per-sample weights and a grouped conv; zero insertion, FIR
    and conv against a transposed conv and FIR), so rounding of ~6e-8
    an operation compounds over the mapping's 8 layers and the ~20
    convs: 4e-7 relative is typical. rel_l2 1e-5 is the benchmark cell's
    limit; the largest difference is held to 1e-5 of the largest value.
    Without the constant noise the images move by far more."""
    res, ch_base, ch_max, n = CASES[case]
    cfg = _cfg(res, ch_base, ch_max)
    forward, state, z = _model(tmp_path, cfg)
    assert isinstance(forward, ModelForward)
    x = _inputs(n, res, 7)
    y = forward(x.numpy())
    want = ref.forward(cfg, state, x, z)
    assert y.shape == want.shape == (n, res, res, 3)
    rel = float((y - want).norm() / want.norm())
    assert rel <= 1e-5, rel
    assert float((y - want).abs().max()) <= 1e-5 * float(want.abs().max())
    quiet = {k: (v * 0 if k.endswith("noise_strength") else v)
             for k, v in state.items()}
    off = ref.forward(cfg, quiet, x, z)
    assert float((off - want).norm() / want.norm()) > 1e-3


SYN = {f"comodgan.syn.b{r}" for r in (4, 8, 16, 32)}
INSIDE = {"comodgan.mapping", "comodgan.encoder"} | SYN


def test_spans_and_counters(tmp_path):
    """The first forward is the set-up span `entry.first_forward`; under
    a profiler a forward is `entry.forward` > `entry.h2d` and
    `comodgan.forward` > mapping, encoder and every synthesis level;
    the counters count forwards and images."""
    forward, _, _ = _model(tmp_path, _cfg(32, 512, 32))
    x = _inputs(3, 32, 1)
    tracing.reset()
    forward(x)
    first = [s for s in tracing.spans() if s.name == "entry.first_forward"]
    assert len(first) == 1
    assert {"comodgan.forward"} | INSIDE <= {s.name for s in tracing.spans()
                                             if s.setup}
    n = len(tracing.spans())
    before = tracing.counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        forward(x)
    after = tracing.counters()
    by = {s.name: s for s in tracing.spans()[n:]}
    assert set(by) == {"entry.forward", "entry.h2d",
                       "comodgan.forward"} | INSIDE
    assert by["entry.h2d"].parent == by["entry.forward"].id
    assert by["comodgan.forward"].parent == by["entry.forward"].id
    for name in INSIDE:
        assert by[name].parent == by["comodgan.forward"].id, name
    assert INSIDE <= {e.name for e in prof.events()}
    for name, d in (("comodgan.forwards", 1), ("comodgan.images", 3)):
        assert after[name] - before.get(name, 0) == d


def test_reference_names_the_port_checkpoint():
    """At the published widths the reference's checkpoint is the port's
    `state_dict`, name for name and shape for shape, with the published
    79,792,231 parameters (80,491,767 with the buffers), and its forward
    does 240.76 GFLOP an image."""
    with torch.device("meta"):
        port = CoModGANGenerator(CoModGANConfig(resolution=512)).state_dict()
    shapes = ref.param_shapes(PUBLISHED)
    assert list(shapes) == list(port)
    assert all(tuple(port[k].shape) == s for k, s in shapes.items())
    assert ref.count_params(PUBLISHED) == 79_792_231
    assert sum(math.prod(s) for s in shapes.values()) == 80_491_767
    flops = comodgan_work.comodgan_flops(PUBLISHED, 2)
    assert flops == 2 * comodgan_work.comodgan_flops(PUBLISHED)
    assert abs(flops / 2 / 1e9 - 240.76) < 0.01
