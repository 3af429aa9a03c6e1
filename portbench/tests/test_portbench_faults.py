"""A run with the timed path broken underneath comes out not correct, for
each fault the cells can have, and a sound run comes out correct; on the
CPU at a tiny size, past the harness's look for a card. (The cells run
on one card, so there is no exchange between cards to leave out, and no
training state to leave unchanged.)"""

import pytest
import torch

from portbench.tests import tiny

torch.set_num_threads(2)


def altered(fwd):
    """An answer altered where it is produced: one value of the last
    image of every call."""
    def f(x):
        y = fwd(x).clone()
        y[-1, 3, 5, 1] += 0.05
        return y
    return f


def altered_first(fwd):
    """The same for a server, whose last row may be padding: the green
    of the first image of every dispatch."""
    def f(x):
        y = fwd(x).clone()
        y[0, :, :, 1] += 0.05
        return y
    return f


def half_left_out(fwd):
    """Half of the batch left out: the first half computed and handed
    back for every row."""
    def f(x):
        x = torch.as_tensor(x)
        n = x.shape[0]
        y = fwd(x[:max(1, n // 2)])
        return y.repeat((n + len(y) - 1) // len(y), 1, 1, 1)[:n]
    return f


CASES = [("closed", tiny.BATCH, "migan512.batch16", altered),
         ("serve", tiny.SERVE, "migan512.serve", altered_first)]


@pytest.mark.parametrize("name, mix, cell, alter", CASES,
                         ids=[c[0] for c in CASES])
def test_sound_run_is_correct(name, mix, cell, alter):
    r = tiny.run(mix, cell, seconds=1.0)
    assert r["correct"], r["check"]
    assert r["failed"] == 0 and r["attempted"] > 0


@pytest.mark.parametrize("fault", ["altered", "half_left_out"])
@pytest.mark.parametrize("name, mix, cell, alter", CASES,
                         ids=[c[0] for c in CASES])
def test_broken_run_is_not_correct(name, mix, cell, alter, fault):
    wrap = alter if fault == "altered" else half_left_out
    r = tiny.run(mix, cell, seconds=1.0, wrap=wrap)
    assert not r["correct"], r["check"]
