"""generator.mfu_pct.<cell kind>: the whole generator step's share of
the card's tensor peak, from the window's images (rows requested, for a
server: padded rows are no work) and the reference's FLOPs per image."""

from portbench.readings import mfu_pct


def read(r):
    return mfu_pct(r)
