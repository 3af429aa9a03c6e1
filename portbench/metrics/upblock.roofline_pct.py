"""upblock.roofline_pct: the upblock kernel's share of its roofline over
the traced calls (`readings.kernel_roofline`, described by
`metrics/kernels/upblock.json`)."""

from portbench.readings import kernel_roofline


def read(r):
    return kernel_roofline(r, "upblock")
