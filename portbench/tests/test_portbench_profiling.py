"""The busy union and window logic, the idle gaps and the readers'
arithmetic on a made-up trace."""

import pytest

from portbench import profiling, readings
from portbench.reference import work


@pytest.mark.parametrize("intervals, window, want", [
    ([(0, 10), (5, 15), (20, 30)], (0, 100), 25),      # overlap once
    ([(0, 10), (2, 3), (4, 5)], (0, 100), 10),         # nested
    ([(-5, 5), (95, 120)], (0, 100), 10),              # clipped both ends
    ([(-10, -1), (101, 200)], (0, 100), 0),            # all outside
    ([(0, 10), (10, 20)], (0, 100), 20),               # touching
])
def test_busy_union(intervals, window, want):
    assert profiling.busy_union(intervals, window) == want


def test_idle_gaps_longest_first_and_clipped():
    gaps = profiling.idle_gaps([(10, 20), (15, 30), (60, 75), (-5, 2)],
                               (0, 100))
    assert gaps == [(30, 60), (75, 100), (2, 10)]


def _trace():
    dev = [("void sepconv_kernel<float>(...)", 100.0, 300.0),
           ("Memcpy HtoD (Pageable -> Device)", 0.0, 90.0),
           ("cudnn_conv", 300.0, 400.0),
           ("void upblock_kernel<float>(...)", 400.0, 600.0),
           ("void rgb_sum_kernel<float>(...)", 600.0, 650.0)]
    ops = [("migan::fused_block",
            [[8, 64, 64, 64], [3, 3, 64], [64], [64, 64], [], [], [], [], []],
            [None] * 5 + [True] + [None] * 3,
            ["float"] * 4 + ["", "Scalar", "", "", ""])]
    spans = [("forward", 0.0, 120.0)]
    t = profiling.Trace((0.0, 1000.0), dev, ops, spans)
    t.units["calls"] = 2
    return t


def test_busy_and_breakdown():
    t = _trace()
    assert t.busy_s() == pytest.approx(640e-6)
    b = profiling.breakdown(t)
    assert b["device_ops"][0][1] == pytest.approx(200e-6)
    assert b["idle_gaps"][0] == ["idle in other host work",
                                 pytest.approx(350e-6)]
    assert b["idle_gaps"][1] == ["idle in forward", pytest.approx(10e-6)]


def test_kernel_roofline_and_per_call_readers():
    t = _trace()
    card = work.peaks("NVIDIA H100 80GB HBM3")
    r = readings.Reading({"dtype": "float32"}, None, t, card)
    flops, nbytes = work.sepconv_work(*t.ops[0][1:])
    pix = 8 * 64 * 64
    assert flops == 2 * pix * (9 * 64 + 64 * 64)
    assert nbytes == 4 * (pix * 64 + 9 * 64 + 64 + 64 * 64 + pix * 64)
    bound = max(nbytes / 3.35e12, flops / 495e12)
    assert readings.kernel_roofline(r, "sepconv") == pytest.approx(
        100 * bound / 200e-6)
    # no calls of an op in the trace: nothing to read
    assert readings.kernel_roofline(r, "downblock") is None
    # plain ops: what is neither a described kernel nor a copy
    plain = readings.per_call_ms(r, readings.plain_ops())
    assert plain == pytest.approx(0.1 / 2)
    assert readings.per_call_ms(
        r, lambda n: n.startswith(readings.COPY)) == pytest.approx(0.045)


def test_no_card_no_share():
    r = readings.Reading({"dtype": "float32"}, None, _trace(), None)
    assert readings.kernel_roofline(r, "sepconv") is None
    assert work.peaks("NVIDIA GeForce RTX 4090") is None
