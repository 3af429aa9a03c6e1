"""comodgan.conv_device_ms: device ms per traced call in the 3x3 and 1x1
convolutions' kernels and their layout transposes
(`metrics/_comodgan.py` names them)."""

from portbench.metrics._comodgan import is_conv
from portbench.readings import per_call_ms


def read(r):
    return per_call_ms(r, is_conv)
