"""On the card: the control, the reference in TF32 in the program's
place, fails each cell's committed limits, and the program at the same
size passes them. Smaller than a run (fewer distinct inputs, a short
window, fewer checked replies), at the cells' own widths and batch.

    python3 -m pytest portbench/tests -q -m cuda
"""

import pytest
import torch

from portbench import check, harness, program

SMALLER = {"closed_loop": dict(pool=16), "open_loop": dict(pool=12,
                                                            rate=5.0)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["migan512.batch16", "migan256.single",
                                  "migan512.serve"])
def test_control_fails_the_limits(card, cell):
    run = harness.load_run(cell, 2 ** 31 + 101, 2.0, False)
    run.mix = dict(run.mix, **SMALLER[run.mix["kind"]])
    run.limits = dict(run.limits, sample_calls=2, sample_requests=6)
    drv = harness.kind(run.mix["kind"])
    try:
        st = drv.setup(run)
        win = drv.measure(run, st)
        drv.release(run, st)
        ok, rows = check.verdict(drv.verify(run, st, win), run.limits)
        bad, crows = check.verdict(drv.control(run, st, win), run.limits)
    finally:
        run.close()
        program.free()
    assert ok, rows
    assert not bad, crows
