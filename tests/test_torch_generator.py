"""The port's generator against the JAX generator on the CPU.

Both the plain `generator_apply` and the kernel chain (`KernelGenerator`,
whose fused ops take their plain versions on CPU tensors) are held against
`migan_tpu.models.migan_inference.generator_apply` on the same weights
(through the .npz bridge) and inputs, with non-zero noise strengths, at
rtol 1e-3 / atol 2e-3: float32 through ~50 convs with clamp-256
activations (the tolerance of tests/test_migan_inference.py).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from migan_tpu.io.checkpoint import save_npz as j_save_npz
from migan_tpu.models.migan_inference import (
    GeneratorConfig as JConfig, generator_apply as j_apply,
    generator_init as j_init,
)
from migan_tpu_torch.io import load_npz
from migan_tpu_torch.models import migan_kernels
from migan_tpu_torch.models.migan_inference import (
    GeneratorConfig, count_params, generator_apply, generator_init,
)
from migan_tpu_torch.models.migan_kernels import KernelGenerator
from migan_tpu_torch.utils import tracing


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The gate runs 6 test workers on one host: torch's default of one
    thread per core in each of them oversubscribes it several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _with_noise(params, rng):
    """Random noise strengths: the init's zeros would bypass the noise."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = _with_noise(v, rng)
        elif k == "noise_strength":
            out[k] = jnp.asarray(rng.randn() * 0.5, jnp.float32)
        else:
            out[k] = v
    return out


@pytest.fixture(scope="module", params=[(64, 4096), (128, 8192)],
                ids=["res64", "res128"])
def pair(request, tmp_path_factory):
    res, ch_base = request.param
    jcfg = JConfig(resolution=res, ch_base=ch_base)
    params = _with_noise(j_init(jax.random.PRNGKey(0), jcfg),
                         np.random.RandomState(res))
    path = str(tmp_path_factory.mktemp("w") / "w.npz")
    j_save_npz(path, params)
    g = load_npz(path, GeneratorConfig(resolution=res, ch_base=ch_base))
    return params, jcfg, g


@pytest.mark.parametrize("wide", [False, True], ids=["square", "non_square"])
def test_generator_matches_jax(pair, wide):
    params, jcfg, g = pair
    res = jcfg.resolution
    shape = (1, res, 2 * res, 4) if wide else (2, res, res, 4)
    x = np.random.RandomState(7).randn(*shape).astype(np.float32)
    want = np.asarray(j_apply(params, jnp.asarray(x), jcfg))
    plain = generator_apply(g, torch.from_numpy(x)).numpy()
    chain = KernelGenerator(g)(torch.from_numpy(x)).numpy()
    assert plain.shape == chain.shape == want.shape == shape[:3] + (3,)
    np.testing.assert_allclose(plain, want, rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(chain, want, rtol=1e-3, atol=2e-3)


def test_kernel_chain_calls_each_fused_op(pair, monkeypatch):
    """Per forward at resolution 2^k: 2k sepconv, k - 2 downblock and
    k - 2 upblock calls, every level of the ladder through the kernels
    (the 4x4 level as four sepconv calls)."""
    _, jcfg, g = pair
    calls = {"fused_block": 0, "fused_down_block": 0, "fused_up_block": 0}
    for name in calls:
        fn = getattr(migan_kernels, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(migan_kernels, name, counted)
    res = jcfg.resolution
    KernelGenerator(g)(torch.zeros(1, res, res, 4))
    k = int(np.log2(res))
    assert calls == {"fused_block": 2 * k, "fused_down_block": k - 2,
                     "fused_up_block": k - 2}


@pytest.mark.parametrize("res,expected", [(256, 5_943_617),
                                          (512, 5_973_366)])
def test_param_count_matches_reference(res, expected):
    """The reference's nn.Parameter counts (BASELINE.md)."""
    g = generator_init(GeneratorConfig(resolution=res),
                       torch.Generator().manual_seed(0))
    assert count_params(g) == expected


def test_init_statistics():
    """kaiming_uniform(a=sqrt 5) weights and U(+-1/sqrt(fan_in)) biases,
    N(0, 1) noise_const, zero noise_strength; the same seed gives the same
    weights."""
    cfg = GeneratorConfig(resolution=64, ch_base=4096)
    g = generator_init(cfg, torch.Generator().manual_seed(3))
    g2 = generator_init(cfg, torch.Generator().manual_seed(3))
    for (k, v), v2 in zip(g.state_dict().items(), g2.state_dict().values()):
        assert torch.equal(v, v2), k
    pw = g.encoder["b64"].conv1.conv2.weight          # fan_in = C = 64
    assert pw.abs().max() <= 1 / 8 and pw.abs().max() > 0.9 / 8
    nc = g.synthesis["b64"].conv1.noise_const
    assert abs(nc.mean().item()) < 0.1 and abs(nc.std().item() - 1) < 0.1
    assert g.synthesis["b64"].conv1.noise_strength.item() == 0.0


def _noisy(res, ch_base, seed):
    """A seeded `Generator` with non-zero noise strengths."""
    g = generator_init(GeneratorConfig(resolution=res, ch_base=ch_base),
                       torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in g.named_parameters():
            if name.endswith("noise_strength"):
                p.fill_(float(rng.randn()) * 0.5)
    return g


def test_kernel_chain_at_migan16_matches_plain():
    """migan-16's two levels, 16 and 8, and its 4x4 level run through the
    kernels (their plain versions here): the chain equals the plain
    forward."""
    g = _noisy(16, 512, 1)
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 16, 16, 4)
                         .astype(np.float32))
    chain = KernelGenerator(g)
    assert chain.kernel_res == [16, 8]
    torch.testing.assert_close(chain(x), generator_apply(g, x))


def test_kernel_chain_matches_plain_at_a_non_square_input():
    """migan-512's ladder (narrow channels) at 512 x 384: every level's
    noise is cropped from the trained planes (`_noise(r, h, w)`), down to
    the 8 x 6 level, and the 4x4 level is 4 x 3."""
    g = _noisy(512, 4096, 5)
    x = torch.from_numpy(np.random.RandomState(6).randn(1, 512, 384, 4)
                         .astype(np.float32))
    got = KernelGenerator(g)(x)
    assert got.shape == (1, 512, 384, 3)
    torch.testing.assert_close(got, generator_apply(g, x))


# (most ops, kernel launches) of one forward of the chain at N = 1 and the
# model's own resolution: 45 and 49 ops measured, with a little room (143
# and 163 before upblock folded the rgb pyramid's 16 ops a level); a level
# run as plain ops dispatches 42-88, and an unfolded pyramid level 16, so
# either creeping back exceeds it
OP_BUDGET = {256: (50, 28), 512: (55, 32)}


@pytest.mark.parametrize("res", sorted(OP_BUDGET))
def test_kernel_chain_dispatches_few_ops(res):
    """One forward at N = 1 dispatches at most the budget's ops, of which
    exactly 2k + 2 (k - 2) are kernel launches (28 at 256, 32 at 512),
    and records no `generator.plain` span: no level runs as plain ops.
    The channels are narrow; the count depends on the ladder alone."""
    g = _noisy(res, res * 8, 3)
    x = torch.from_numpy(np.random.RandomState(4).randn(1, res, res, 4)
                         .astype(np.float32))
    chain = KernelGenerator(g)
    with tracing.OpCount() as ops:
        chain(x)
    budget, kernels = OP_BUDGET[res]
    assert ops.kernels == kernels
    assert ops.total <= budget, ops.total
    tracing.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        chain(x)
    names = {s.name for s in tracing.spans()}
    assert "generator.plain" not in names
    assert {"generator.enc.b4", "generator.syn.b4",
            "generator.enc.b8", "generator.syn.b8"} <= names
