"""plain_ops.device_ms: device ms per traced forward outside the
hand-written kernels and the host copies (cuDNN convolutions, the FIR
resampling and elementwise ops of the levels below the kernels)."""

from portbench.readings import per_call_ms, plain_ops


def read(r):
    return per_call_ms(r, plain_ops())
