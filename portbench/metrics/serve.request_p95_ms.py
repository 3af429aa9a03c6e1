"""serve.request_p95_ms: nearest-rank 95th percentile of the window's
requests, each from its due time to its reply. Above the server's
capacity the queue grows all through the window, so this tail swings
with the smallest change: a per-layer reading there, not a bound."""

from portbench.traffic.schedule import nearest_rank


def read(r):
    lat = getattr(r.window, "latency_s", None)
    return 1e3 * nearest_rank(lat, 0.95) if lat else None
