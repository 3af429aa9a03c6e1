"""The port's small surfaces against the JAX package on the CPU:
`ops.upfirdn2d.filter2d` and the `padding` / `flip_filter` / `gain`
arguments of `upsample2d` / `downsample2d` (rtol / atol 1e-6; the
defaults bit-equal to the calls before those arguments), the parameter
summary of a bridged generator (`utils/summary.py`: count equal, sum
rtol 1e-6), `cli/calculate_flops.py` at migan-256 (within [0.95, 1.0] of
the JAX CLI's XLA cost analysis, which also counts elementwise ops), and
`utils/logging.py`'s profiler scopes in a CPU `torch.profiler` trace."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from migan_tpu import ops as jops
from migan_tpu.cli import calculate_flops as j_flops
from migan_tpu.io.checkpoint import save_npz as j_save_npz
from migan_tpu.models import migan_inference as jmi
from migan_tpu.utils import summary as j_summary
from migan_tpu_torch import ops as tops
from migan_tpu_torch.cli import calculate_flops
from migan_tpu_torch.io import load_npz
from migan_tpu_torch.utils import summary, tracing

TOL = 1e-6


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("taps", [[1, 3, 3, 1], [1, 2, 1], [1, 1]])
@pytest.mark.parametrize("padding,flip_filter,gain", [
    (0, False, 1.0), (1, True, 2.0), ((2, 0, 1, 3), False, 0.5),
    ((-1, 1, 0, -1), True, 1.5)])
@pytest.mark.parametrize("fn", ["filter2d", "upsample2d", "downsample2d"])
def test_resampling_arguments_match_jax(fn, taps, padding, flip_filter,
                                        gain):
    x = _x((2, 9, 12, 5))
    fj, ft = jops.setup_filter(taps), tops.setup_filter(taps)
    want = np.asarray(getattr(jops, fn)(
        jnp.asarray(x), fj, padding=padding, flip_filter=flip_filter,
        gain=gain))
    got = getattr(tops, fn)(torch.from_numpy(x), ft, padding=padding,
                            flip_filter=flip_filter, gain=gain).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("factor", [2, (2, 1)])
def test_resampling_defaults_unchanged(factor):
    """The defaults compute what the two-argument calls computed: the
    padding of reference upfirdn2d.py:334-343 / :373-382 and the gain
    up*up, bit for bit."""
    x = torch.from_numpy(_x((2, 8, 6, 3), seed=1))
    f = tops.setup_filter([1, 3, 3, 1])
    fx, fy = tops.parse_scaling(factor)
    up = tops.upfirdn2d(x, f, up=factor,
                        padding=[(4 + fx - 1) // 2, (4 - fx) // 2,
                                 (4 + fy - 1) // 2, (4 - fy) // 2],
                        gain=fx * fy)
    down = tops.upfirdn2d(x, f, down=factor,
                          padding=[(4 - fx + 1) // 2, (4 - fx) // 2,
                                   (4 - fy + 1) // 2, (4 - fy) // 2])
    assert torch.equal(tops.upsample2d(x, f, factor), up)
    assert torch.equal(tops.downsample2d(x, f, factor), down)


def test_param_summary_of_a_bridged_generator(tmp_path):
    cfg = jmi.GeneratorConfig(resolution=64)
    params = jmi.generator_init(jax.random.PRNGKey(3), cfg)
    j_save_npz(str(tmp_path / "g.npz"), params)
    g = load_npz(str(tmp_path / "g.npz"))
    assert summary.param_count(g) == j_summary.param_count(params)
    np.testing.assert_allclose(summary.param_sum(g),
                               j_summary.param_sum(params), rtol=TOL)
    assert summary.param_count(g.state_dict()) == summary.param_count(g)
    lines = []
    total = summary.print_param_summary(g, "migan-64", print_fn=lines.append)
    want = []
    assert total == j_summary.print_param_summary(params, "migan-64",
                                                  print_fn=want.append)
    assert lines == want


def test_calculate_flops_against_jax():
    res = 256
    cfg = jmi.GeneratorConfig(resolution=res)
    params = jmi.generator_init(jax.random.PRNGKey(0), cfg)
    want = j_flops.flops_of(lambda p, xx: jmi.generator_apply(p, xx, cfg),
                            params, jnp.zeros((1, res, res, 4), jnp.float32))
    got = calculate_flops.main(["--models", f"migan-{res}"])[f"migan-{res}"]
    assert 0.95 * want <= got <= want, (got, want)


def test_trace_scopes_in_a_profiler_trace():
    """Under a profiler a span is a range of the profiler's trace and a
    record of the tracer, with the span around it as its parent."""
    tracing.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.span("port.trace_scope"):
            with tracing.span("port.inner"):
                torch.ones(3) + 1
    names = {e.name for e in prof.events()}
    assert {"port.trace_scope", "port.inner"} <= names
    got = {s.name: s for s in tracing.spans()}
    assert got["port.inner"].parent == got["port.trace_scope"].id
