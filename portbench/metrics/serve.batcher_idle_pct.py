"""serve.batcher_idle_pct: the batcher's share of its time blocked on an
empty queue in the traced stretch, 100 x the `batcher.idle` spans' time
over that of `batcher.idle`, `batcher.fill` and `batcher.dispatch`: how
long the batcher, and so the card, waits for the handlers."""

from portbench.metrics._program import share_pct

LOOP = ["batcher.idle", "batcher.fill", "batcher.dispatch"]


def read(r):
    return share_pct(["batcher.idle"], LOOP)
