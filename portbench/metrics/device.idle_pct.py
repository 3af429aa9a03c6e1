"""device.idle_pct.<cell kind>: 100 minus the share of the traced window
in which any device operation ran (`profiling.busy_union`)."""


def read(r):
    if r.trace is None or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s() / r.trace.window_s)
