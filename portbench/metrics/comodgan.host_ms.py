"""comodgan.host_ms.<cell kind>: mean wall ms of the program's
`comodgan.forward` spans in the traced stretch: the host's dispatch of
one Co-Mod-GAN forward, to put beside its device time."""

from portbench.metrics._program import mean_ms


def read(r):
    return mean_ms("comodgan.forward")
