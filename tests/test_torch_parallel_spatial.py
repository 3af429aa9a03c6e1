"""The port's spatial (image-height) sharding of the generator forward
(`migan_tpu_torch/parallel/spatial.py`) on gloo ranks
(`tests/test_torch_parallel_worker.py`, role `spatial`) on the CPU,
against `tests/test_multihost.py::test_spatial_sharded_inference`'s
geometry: `GeneratorConfig(resolution=64)` on `[2,128,128,4]` from
`np.random.RandomState(0)`, the weights of `generator_init(PRNGKey(0))`
carried across through the .npz bridge with random non-zero noise
strengths (the init's zeros would hide the noise's rows).

  - 2 and 8 ranks: the gathered output equals the port's one-process
    `generator_apply` within rtol/atol 1e-5 (the JAX test's bound) and
    the JAX package's `generator_apply` within 1e-3 / 2e-3
    (`test_torch_generator.py`'s bound); each rank holds its rows only.
  - float64 on 2 ranks (a narrower net, ch_base 4096): within 1e-12 of
    the one-process float64 forward.
  - 8 ranks on a 64-row input: the lowest level (4 rows) does not split
    over 8 ranks and is gathered; the same 1e-5 bound.
  - The control, on 8 ranks: noise tiled to a rank's own height instead
    of the level's global height misses by more than the bound (on 2
    ranks at this geometry the two tilings agree: each rank's block is
    one period of noise_const).
  - `shard_rows` then `gather_rows` is the identity (in each rank), and a
    global H that the one-process forward refuses raises ValueError.
  - `cli/spatial.py` under `torch.distributed.run` on 2 gloo ranks: exit
    0 and its JSON line (the gathered rows within the bound).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from migan_tpu.io.checkpoint import save_npz as j_save_npz
from migan_tpu.models import migan_inference as jmi
from migan_tpu_torch.io import load_npz
from migan_tpu_torch.models.migan_inference import (
    GeneratorConfig, generator_apply, generator_init,
)
from migan_tpu_torch.parallel import generator_apply_spatial
from test_torch_generator import _with_noise
from test_torch_parallel_worker import REPO, launch


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The gate runs 6 test workers on one host: torch's default of one
    thread per core in each of them oversubscribes it several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


SHARD_TOL = 1e-5            # tests/test_multihost.py's rtol and atol
JAX_RTOL, JAX_ATOL = 1e-3, 2e-3
F64_TOL = 1e-12
RES = 64


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    """(JAX params, port generator at the JAX test's width, the narrow
    float64 generator, the JAX test's input)."""
    cfg = jmi.GeneratorConfig(resolution=RES)
    params = _with_noise(jmi.generator_init(jax.random.PRNGKey(0), cfg),
                         np.random.RandomState(RES))
    path = str(tmp_path_factory.mktemp("w") / "w.npz")
    j_save_npz(path, params)
    g = load_npz(path, GeneratorConfig(resolution=RES))
    narrow = generator_init(GeneratorConfig(resolution=RES, ch_base=4096),
                            torch.Generator().manual_seed(1))
    with torch.no_grad():
        for name, p in narrow.named_parameters():
            if name.endswith("noise_strength"):
                p.fill_(0.5)
    x = np.random.RandomState(0).randn(2, 128, 128, 4).astype(np.float32)
    return params, g, narrow.double(), x


def _run(tmp_path, nets, nproc, cases):
    _, g, narrow, _ = nets
    inp, out = str(tmp_path / "in.pt"), str(tmp_path / "out")
    torch.save({"generators": {"wide": g, "narrow": narrow},
                "cases": cases}, inp)
    launch("spatial", inp, out, nproc)
    return [torch.load(f"{out}.{r}", weights_only=False)
            for r in range(nproc)]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, nets):
    x = torch.from_numpy(nets[3])
    return _run(tmp_path_factory.mktemp("sp2"), nets, 2, [
        {"name": "geometry", "generator": "wide", "x": x},
        {"name": "float64", "generator": "narrow", "x": x},
        {"name": "refused", "generator": "wide", "x": x[:, :40]},
    ])


@pytest.fixture(scope="module")
def eight_ranks(tmp_path_factory, nets):
    x = torch.from_numpy(nets[3])
    return _run(tmp_path_factory.mktemp("sp8"), nets, 8, [
        {"name": "geometry", "generator": "wide", "x": x},
        {"name": "uneven", "generator": "wide", "x": x[:, :64]},
        {"name": "local_noise", "generator": "wide", "x": x,
         "local_noise": True},
    ])


@pytest.fixture(scope="module")
def one_process(nets):
    """The port's one-process forward and the JAX package's, on the
    whole input."""
    params, g, _, x = nets
    return (generator_apply(g, torch.from_numpy(x)).numpy(),
            np.asarray(jmi.generator_apply(params, jnp.asarray(x),
                                           jmi.GeneratorConfig(
                                               resolution=RES))))


def _gathered(ranks, name, rows):
    """The ranks' outputs of case `name` in rank order, each checked to
    hold its `rows` rows only."""
    parts = [r[name] for r in ranks]
    for p in parts:
        assert p.shape[1] == rows, p.shape
    return torch.cat(parts, dim=1).numpy()


@pytest.mark.parametrize("nproc", [2, 8])
def test_spatial_forward_matches_one_process_and_jax(
        nproc, two_ranks, eight_ranks, one_process):
    ranks = {2: two_ranks, 8: eight_ranks}[nproc]
    got = _gathered(ranks, "geometry", 128 // nproc)
    port, jax_out = one_process
    assert got.shape == (2, 128, 128, 3)
    np.testing.assert_allclose(got, port, rtol=SHARD_TOL, atol=SHARD_TOL)
    np.testing.assert_allclose(got, jax_out, rtol=JAX_RTOL, atol=JAX_ATOL)


def test_spatial_forward_float64(two_ranks, nets):
    _, _, narrow, x = nets
    got = _gathered(two_ranks, "float64", 64)
    want = generator_apply(narrow, torch.from_numpy(x).double()).numpy()
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=F64_TOL, atol=F64_TOL)


def test_spatial_forward_gathers_the_uneven_levels(eight_ranks, nets):
    """64 rows over 8 ranks: 8, 4, 2, 1 rows a rank at the levels 64..8,
    and the 4-row level run whole on every rank."""
    _, g, _, x = nets
    got = _gathered(eight_ranks, "uneven", 8)
    want = generator_apply(g, torch.from_numpy(x[:, :64])).numpy()
    np.testing.assert_allclose(got, want, rtol=SHARD_TOL, atol=SHARD_TOL)


def test_local_noise_control_misses(eight_ranks, one_process):
    got = _gathered(eight_ranks, "local_noise", 16)
    port, _ = one_process
    miss = np.abs(got - port) - SHARD_TOL * np.abs(port)
    assert miss.max() > SHARD_TOL, miss.max()


def test_shard_gather_identity_and_refusal(two_ranks, nets):
    """The worker holds gather_rows(shard_rows(x)) equal to x in every
    rank for every case; a 40-row input (migan-64 needs multiples of 16)
    is refused on 2 ranks as in one process."""
    _, g, _, x = nets
    for r in two_ranks:
        assert "not a multiple of 16" in r["refused"]
    with pytest.raises(ValueError, match="not a multiple of 16"):
        generator_apply_spatial(g, torch.from_numpy(x[:, :40]))


def test_spatial_cli_on_two_gloo_ranks(tmp_path):
    from migan_tpu_torch.cli.trace import seeded_generator
    from migan_tpu_torch.io import save_npz

    path = str(tmp_path / "w.npz")
    save_npz(path, seeded_generator(RES, 3))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "migan_tpu_torch.cli.spatial",
         "--model-name", f"migan-{RES}", "--model-path", path, "--size",
         "64", "--reps", "1", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    (line,) = [l for l in r.stdout.splitlines() if l.startswith("{")]
    out = json.loads(line)
    assert out["world"] == 2 and out["rows"] == 32 and out["finite"]
    assert out["shape"] == [1, 64, 64, 3]
    assert out["max_abs_err"] <= SHARD_TOL and out["excess"] <= 0
    assert len(out["ms"]["spatial"]) == len(out["ms"]["plain"]) == 2


def test_spatial_cli_refuses_cuda_without_a_card(tmp_path):
    """No fallback: `--device cuda` (the default) raises where no card is
    present, before any work."""
    from migan_tpu_torch.cli import spatial

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal cannot show")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spatial.main(["--model-name", "migan-64", "--model-path",
                      str(tmp_path / "absent.npz"), "--size", "64"])
