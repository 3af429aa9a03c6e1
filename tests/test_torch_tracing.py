"""The port's spans and counters (`migan_tpu_torch/utils/tracing.py`) on
the CPU: nothing recorded while off; under a CPU `torch.profiler` spans
with parents, requests and CPU time, which are also ranges of the
profiler's events; the ring's bound; counters under threads; and the
spans of `load_model`'s forward, the first forward's always, the
generator's levels only while on, none under `torch.export`.
"""

import collections
import re
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

import migan_tpu_torch
from migan_tpu_torch.cli.demo import load_model
from migan_tpu_torch.io import save_npz
from migan_tpu_torch.models.migan_inference import (
    GeneratorConfig, generator_init,
)
from migan_tpu_torch.utils import tracing

CPU = [torch.profiler.ProfilerActivity.CPU]


def _profile():
    return torch.profiler.profile(activities=CPU)


def _burn(seconds: float) -> None:
    t = time.perf_counter() + seconds
    while time.perf_counter() < t:
        pass


@pytest.fixture
def model(tmp_path):
    """A fresh migan-64 `load_model` forward on the CPU: every level
    through the kernel ops (their plain versions)."""
    path = str(tmp_path / "g.npz")
    save_npz(path, generator_init(GeneratorConfig(resolution=64),
                                  torch.Generator().manual_seed(3)))
    tracing.reset()
    forward, res = load_model("migan-64", path, "float32", "cpu")
    return forward, torch.zeros(1, res, res, 4)


def test_nothing_is_recorded_while_off():
    tracing.reset()
    assert not tracing.on() and tracing.mark() is None
    with tracing.span("serve.request", new_request=True) as s:
        assert s is None
        with tracing.span("serve.decode"):
            pass
    assert tracing.spans() == () and tracing.dropped() == 0


def test_spans_under_a_profiler_have_parents_requests_and_cpu_time():
    """Spans opened with `cpu=True` hold the thread's CPU time, the
    others and those with explicit times none."""
    tracing.reset()
    with _profile() as prof:
        assert tracing.on()
        with tracing.span("serve.request", new_request=True):
            with tracing.span("serve.decode", cpu=True):
                _burn(0.02)
            with tracing.span("serve.encode", cpu=True):
                time.sleep(0.02)
            m = tracing.mark()
            time.sleep(0.02)
            tracing.record("serve.queue_wait", m.start_ns,
                           time.perf_counter_ns(), m)
        with tracing.span("batcher.dispatch", request=(7, 8)):
            pass
    got = {s.name: s for s in tracing.spans()}
    root, decode = got["serve.request"], got["serve.decode"]
    wait, dispatch = got["serve.queue_wait"], got["batcher.dispatch"]
    assert root.parent is None and root.request == root.id
    assert decode.parent == wait.parent == root.id
    assert decode.request == wait.request == root.id
    assert dispatch.request == (7, 8) and dispatch.parent is None
    # a busy thread's CPU time is within its wall time; a sleep's is small
    assert 0 < decode.cpu_ns <= decode.wall_ns + 1e6
    assert got["serve.encode"].cpu_ns < 0.5 * got["serve.encode"].wall_ns
    assert wait.cpu_ns is None and wait.wall_ns >= 15e6
    assert root.cpu_ns is None and dispatch.cpu_ns is None
    assert root.start_ns <= decode.start_ns < decode.end_ns <= root.end_ns
    assert not any(s.setup for s in got.values())
    names = [e.name for e in prof.events()]
    assert {"serve.request", "serve.decode", "batcher.dispatch"} <= \
        set(names)
    assert "serve.queue_wait" not in names    # explicit times: store only


def test_a_set_up_span_records_always_and_its_children_with_it():
    tracing.reset()
    with tracing.setup_span("entry.load"):
        assert tracing.on()
        with tracing.span("generator.forward"):
            pass
    with tracing.span("generator.forward"):
        pass
    inner, outer = tracing.spans()
    assert (inner.name, outer.name) == ("generator.forward", "entry.load")
    assert inner.setup and outer.setup and inner.parent == outer.id


def test_set_up_spans_do_not_turn_on_other_threads():
    tracing.reset()
    seen = []
    t = threading.Thread(target=lambda: seen.append(tracing.on()))
    with tracing.setup_span("entry.load"):
        t.start()
        t.join(timeout=10)
    assert not t.is_alive() and seen == [False]


def test_no_program_span_takes_a_name_kept_outside_the_program():
    """The names `forward` and `d2h`, and those starting with
    `portbench.` or `migan::`, belong to callers outside the program and
    to the kernels' ops: no span site of the package uses one."""
    site = re.compile(r'tracing\.(?:span|setup_span|record)\(\s*"([^"]+)"')
    level = re.compile(r'f"(generator\.(?:enc|syn)\.b)\{r\}"')
    names = set()
    for p in Path(migan_tpu_torch.__file__).parent.rglob("*.py"):
        text = p.read_text()
        names |= set(site.findall(text))
        names |= {m + "<r>" for m in level.findall(text)}
    assert {"serve.request", "generator.fromrgb", "entry.first_forward",
            "kernels.load_library"} <= names
    assert "generator.plain" not in names
    for n in names:
        assert n not in ("forward", "d2h"), n
        assert not n.startswith(("portbench.", "migan::")), n


def test_the_ring_keeps_the_newest_and_counts_the_dropped(monkeypatch):
    monkeypatch.setattr(tracing, "_ring", collections.deque(maxlen=4))
    tracing.reset()
    with tracing.setup_span("entry.load"):
        for i in range(9):
            with tracing.span(f"level.{i}"):
                pass
    assert [s.name for s in tracing.spans()] == [
        "level.6", "level.7", "level.8", "entry.load"]
    assert tracing.dropped() == 6
    tracing.reset()
    assert tracing.spans() == () and tracing.dropped() == 0


def test_counters_lose_no_add_under_threads():
    """8 threads add to two counters and read them all at a tiny switch
    interval: no update is lost."""
    tracing.reset_counters("stress.")
    n_threads, n_adds = 8, 4000

    def work():
        for _ in range(n_adds):
            tracing.add("stress.one")
            tracing.add("stress.three", 3)
            tracing.counters()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    c = tracing.counters()
    assert c["stress.one"] == n_threads * n_adds
    assert c["stress.three"] == 3 * n_threads * n_adds
    tracing.reset_counters("stress.")
    assert not any(k.startswith("stress.") for k in tracing.counters())


LEVELS = {"generator.forward", "generator.fromrgb",
          *(f"generator.{side}.b{r}" for side in ("enc", "syn")
            for r in (64, 32, 16, 8, 4))}


def test_load_model_forward_spans(model):
    """`entry.load` and the first forward with its children always, once;
    later forwards only under the profiler."""
    forward, x = model
    names = [s.name for s in tracing.spans()]
    assert names == ["entry.load"]
    forward(x)
    first = [s for s in tracing.spans() if s.name == "entry.first_forward"]
    assert len(first) == 1
    inside = [s for s in tracing.spans() if s.setup and s.name not in
              ("entry.first_forward", "entry.load")]
    assert {s.name for s in inside} == LEVELS | {"entry.h2d"}
    n = len(tracing.spans())
    forward(x)
    assert len(tracing.spans()) == n
    with _profile() as prof:
        forward(x)
    new = tracing.spans()[n:]
    by = {s.name: s for s in new}
    assert set(by) == LEVELS | {"entry.h2d", "entry.forward"}
    assert not any(s.setup for s in new)
    assert by["generator.forward"].parent == by["entry.forward"].id
    for name in LEVELS - {"generator.forward"}:
        assert by[name].parent == by["generator.forward"].id
    assert "generator.plain" not in by
    for name in LEVELS - {"generator.forward"}:
        assert by[name].wall_ns < by["generator.forward"].wall_ns
    assert LEVELS <= {e.name for e in prof.events()}
    assert [s.name for s in tracing.spans()].count(
        "entry.first_forward") == 1


@pytest.mark.parametrize("strict", [False, True])
def test_export_of_the_forward_records_nothing(model, strict):
    """`torch.export` of `load_model`'s forward succeeds, in both modes,
    records no span, and leaves the first forward to the first call."""
    forward, x = model
    tracing.reset()
    program = torch.export.export(forward, (x,), strict=strict)
    assert tracing.spans() == ()
    assert torch.equal(program.module()(x), forward(x))
    assert [s.name for s in tracing.spans()].count(
        "entry.first_forward") == 1
