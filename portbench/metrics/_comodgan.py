"""What the Co-Mod-GAN cell's device-time readers share: which device
kernels are its convolutions. Co-Mod-GAN runs on plain ops, so they are
the library's kernels, told apart by fragments of their names as the
trace records them: cuDNN's implicit-GEMM and direct engines for the
3x3 and 1x1 convs, and the layout transposes that cuDNN runs around
them. The FIR passes are depthwise convolutions of 4x4 taps in kernels
of their own (cuDNN's grouped direct kernel, ATen's depthwise kernel),
which the modulated convs never take (the program runs them with shared
weights, groups 1): those count as the other work, with the
elementwise passes and the dense layers' products."""

from __future__ import annotations

from portbench.readings import COPY

CONV = ("implicit_gemm", "xmma_fprop", "convolve_", "winograd", "fft",
        "nhwcToNchw", "nchwToNhwc")


def is_conv(name: str) -> bool:
    return any(f in name for f in CONV)


def is_other(name: str) -> bool:
    """Neither a convolution nor a copy between host and device."""
    return not is_conv(name) and not name.startswith(COPY)
