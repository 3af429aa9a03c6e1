"""entry.copy_ms.<cell kind>: device ms per traced call of the copies
between host and device (the input's and the output's)."""

from portbench.readings import COPY, per_call_ms


def read(r):
    return per_call_ms(r, lambda n: n.startswith(COPY))
