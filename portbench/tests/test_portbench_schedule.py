"""The open-loop schedule, the due-time timing and the nearest rank."""

import numpy as np
import pytest

from portbench.traffic import schedule


def test_every_seed_gets_the_same_gaps_in_its_own_order():
    a = schedule.poisson_gaps(40.0, 30.0, 1)
    b = schedule.poisson_gaps(40.0, 30.0, 2 ** 31 + 5)
    assert len(a) == len(b) == 1200
    assert not np.array_equal(a, b)
    np.testing.assert_allclose(np.sort(a), np.sort(b))
    # the mean gap is 1 / rate, so the load offered is the rate
    assert abs(a.mean() - 1 / 40.0) < 0.01 / 40.0


def test_due_times_start_at_zero_and_fit_the_window():
    due = schedule.due_times(25.0, 10.0, 7)
    assert due[0] == 0.0 and np.all(np.diff(due) > 0)
    assert len(due) == 250 and 9.0 < due[-1] < 10.0


def test_latency_counts_from_the_due_time():
    # a request due at 1.0 that the sender could only send at 1.5 and
    # that came back at 1.6 waited 0.6 s, not 0.1 s
    assert schedule.latencies([0.0, 1.0], [0.2, 1.6]) == pytest.approx(
        [0.2, 0.6])


@pytest.mark.parametrize("q, want", [(0.5, 50), (0.95, 95), (0.951, 96),
                                     (1.0, 100), (0.001, 1)])
def test_nearest_rank(q, want):
    vals = list(range(100, 0, -1))          # order does not matter
    assert schedule.nearest_rank(vals, q) == want
