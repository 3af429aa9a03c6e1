"""generator.host_ms.<cell kind>: mean host ms from the forward call to
its return, before the output's copy waits for the device (the host's
dispatch of the whole forward, its input copy included)."""


def read(r):
    host = getattr(r.window, "host_s", None)
    return 1e3 * sum(host) / len(host) if host else None
