"""The trace tool's busy share: the union of device intervals clipped to the
profiled window, so overlapping or out-of-window events never count twice
and the share never passes 100%. Its seeded inputs are reproducible."""

import pytest
import torch

from migan_tpu_torch.cli.trace import busy_union, main, seeded_input


@pytest.mark.parametrize("intervals,window,want", [
    ([], (0, 10), 0.0),
    ([(1, 3), (5, 6)], (0, 10), 3.0),               # disjoint
    ([(0, 2), (1, 3), (2.5, 4)], (0, 10), 4.0),     # overlapping chain
    ([(1, 9), (2, 3), (4, 5)], (0, 10), 8.0),       # nested
    ([(-5, 2), (8, 15)], (0, 10), 4.0),             # clipped at both ends
    ([(11, 12), (-3, -1)], (0, 10), 0.0),           # wholly outside
    ([(i * 0.5, i * 0.5 + 3) for i in range(40)], (0, 10), 10.0),  # dense
])
def test_busy_union(intervals, window, want):
    assert busy_union(intervals, window) == pytest.approx(want)


def test_seeded_input_is_reproducible():
    a, b = seeded_input(2, 16, 3), seeded_input(2, 16, 3)
    assert a.shape == (2, 16, 16, 4) and torch.equal(a, b)
    assert set(a[..., 0].unique().tolist()) <= {-0.5, 0.5}


def test_trace_exits_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert main([]) == 1
