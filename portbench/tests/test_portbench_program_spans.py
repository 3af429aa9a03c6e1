"""The readers of the program's own spans on a made-up store, with no
store (a program without the tracer), and the set-up span of a tiny
CPU run."""

import sys

import pytest

from migan_tpu_torch.utils import tracing
from portbench import harness
from portbench.tests import tiny

MS = 1_000_000


def _span(name, start_ms, wall_ms, cpu_ms=None, setup=False):
    start = int(start_ms * MS)
    cpu = None if cpu_ms is None else int(cpu_ms * MS)
    return tracing.Span(name, start, start + int(wall_ms * MS), cpu, 1,
                        None, None, setup)


STORE = (
    _span("entry.first_forward", 0, 9000, 8000, setup=True),
    _span("generator.forward", 1, 8000, 8000, setup=True),
    _span("generator.plain", 2, 7000, 7000, setup=True),
    _span("serve.decode", 10, 4, 3),
    _span("serve.decode", 20, 6, 1),
    _span("serve.encode", 30, 10, 6),
    _span("serve.queue_wait", 40, 100),
    _span("serve.queue_wait", 50, 300),
    _span("batcher.idle", 60, 10, 0),
    _span("batcher.fill", 70, 2, 1),
    _span("batcher.dispatch", 80, 28, 20),
    _span("generator.forward", 90, 8, 8),
    _span("generator.plain", 91, 2, 2),
    _span("generator.forward", 100, 12, 12),
    _span("generator.plain", 101, 3, 3),
)

WANT = {
    "serve.decode_ms": 5.0,
    "serve.encode_ms": 10.0,
    "serve.queue_wait_ms": 200.0,
    "serve.batcher_idle_pct": 25.0,            # 10 of 10 + 2 + 28
    "serve.handler_cpu_pct": 50.0,             # 3 + 1 + 6 of 4 + 6 + 10
    "generator.plain_host_pct.single": 25.0,   # 2 + 3 of 8 + 12; set-up out
    "entry.first_forward_s": 9.0,
}


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_on_a_made_up_store(metric, monkeypatch):
    monkeypatch.setattr(tracing, "spans", lambda: STORE)
    got = harness.reader(metric).read(None)
    assert got == pytest.approx(WANT[metric])


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_of_an_empty_store_reads_nothing(metric, monkeypatch):
    monkeypatch.setattr(tracing, "spans", lambda: ())
    assert harness.reader(metric).read(None) is None


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_of_a_program_without_the_tracer_reads_nothing(
        metric, monkeypatch):
    import migan_tpu_torch.utils

    monkeypatch.setattr(tracing, "spans", lambda: STORE)
    monkeypatch.delattr(migan_tpu_torch.utils, "tracing")
    monkeypatch.setitem(sys.modules, "migan_tpu_torch.utils.tracing", None)
    assert harness.reader(metric).read(None) is None


def test_a_run_records_its_first_forward():
    """A tiny CPU run's set-up holds one first forward of the program,
    which the reader reads, and no span of the stretch (not traced)."""
    tracing.reset()
    r = tiny.run(tiny.BATCH, "migan512.batch16", seconds=0.3)
    assert r["correct"]
    got = harness.reader("entry.first_forward_s").read(None)
    assert got is not None and 0 < got < r["metrics"]["setup_s"]["value"]
    assert all(s.setup for s in tracing.spans())
