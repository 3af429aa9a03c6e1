"""downblock.roofline_pct: the downblock kernel's share of its roofline over
the traced calls (`readings.kernel_roofline`, described by
`metrics/kernels/downblock.json`)."""

from portbench.readings import kernel_roofline


def read(r):
    return kernel_roofline(r, "downblock")
