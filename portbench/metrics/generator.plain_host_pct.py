"""generator.plain_host_pct.<cell kind>: the plain levels' share of the
host's dispatch of the generator, 100 x the wall time of the traced
stretch's `generator.plain` spans over that of its `generator.forward`
spans."""

from portbench.metrics._program import share_pct


def read(r):
    return share_pct(["generator.plain"], ["generator.forward"])
