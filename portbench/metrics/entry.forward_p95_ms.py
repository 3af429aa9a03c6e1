"""entry.forward_p95_ms: nearest-rank 95th percentile of the window's
calls, each timed from host input to host output."""

from portbench.traffic.schedule import nearest_rank


def read(r):
    lat = getattr(r.window, "latency_s", None)
    return 1e3 * nearest_rank(lat, 0.95) if lat else None
