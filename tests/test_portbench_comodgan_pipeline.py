"""The benchmark's Co-Mod-GAN and app-pipeline kinds
(`portbench/traffic/comodgan_closed_loop.py`, `pipeline_loop.py`) in
tiny runs on the CPU through `portbench.run.execute`, as
`portbench/tests/tiny.py` runs the others, with the cells' committed
limits: a sound run comes out correct, a run whose timed path is broken
underneath does not."""

import time

import pytest
import torch

from portbench import harness
from portbench import run as prun
from portbench.tests import tiny

COMODGAN = dict(name="comodgan-32", model_name="comodgan-32", resolution=32,
                ch_base=512, ch_max=32, ic_n=4, rgb_n=3, z_dim=512,
                w_dim=512, w0_dim=1024, mapping_layers=8, num_ws=10,
                dtype="float32")
COMOD = dict(kind="comodgan_closed_loop", batch=4, pool=8, hole=[0.1, 0.6],
             warmup_calls=1, trace_calls=2)
# photos of three sizes around migan-32, one object hole each
PIPE = dict(kind="pipeline_loop", pool=6, sizes=[[64, 48], [48, 64],
                                                 [40, 40]],
            mask="object", hole=[0.03, 0.2], padding=8, warmup_calls=3,
            trace_calls=2)
CELLS = {"comodgan": (COMODGAN, COMOD, "comodgan512.batch16"),
         "pipeline": (tiny.CONFIG, PIPE, "migan512.pipeline")}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(cell, wrap=None) -> dict:
    config, mix, name = CELLS[cell]
    r = harness.Run(tiny.ROOT, {"name": name, "chips": 1}, config, mix,
                    tiny.limits(name), 2 ** 31 + 9, 0.5, False, "cpu",
                    [{"name": "setup_s", "unit": "s"}], [], wrap=wrap)
    return prun.execute(r, time.perf_counter())


def altered(fwd):
    """One value of the last image of every call."""
    def f(x):
        y = fwd(x).clone()
        y[-1, 3, 5, 1] += 0.05
        return y
    return f


def green(fwd):
    """The green of every pixel: in the pipeline only the hole shows the
    generator's output."""
    def f(x):
        y = fwd(x).clone()
        y[..., 1] += 0.05
        return y
    return f


def half_left_out(fwd):
    """The first half of the batch computed and handed back for every
    row."""
    def f(x):
        x = torch.as_tensor(x)
        n = x.shape[0]
        y = fwd(x[:max(1, n // 2)])
        return y.repeat((n + len(y) - 1) // len(y), 1, 1, 1)[:n]
    return f


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"], r["check"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert "setup_s" in r["metrics"]


@pytest.mark.parametrize("cell, fault", [("comodgan", altered),
                                         ("comodgan", half_left_out),
                                         ("pipeline", green)],
                         ids=["comodgan-altered", "comodgan-half_left_out",
                              "pipeline-green"])
def test_broken_run_is_not_correct(cell, fault):
    r = _run(cell, wrap=fault)
    assert not r["correct"], r["check"]
