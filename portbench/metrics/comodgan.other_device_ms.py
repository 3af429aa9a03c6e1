"""comodgan.other_device_ms: device ms per traced call outside the
convolutions and the host copies: the FIR passes, zero insertion and
pads, modulation, demodulation, noise, bias-act and the dense layers."""

from portbench.metrics._comodgan import is_other
from portbench.readings import per_call_ms


def read(r):
    return per_call_ms(r, is_other)
