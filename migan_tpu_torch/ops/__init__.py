"""Op layer of the port: resampling, the activation, plain convs, and the
hand-written CUDA kernels (`ops.kernels`)."""

from .filters import setup_filter, parse_padding, parse_scaling, filter_size
from .upfirdn2d import upfirdn2d, upsample2d, downsample2d
from .bias_act import lrelu_agc
from .conv import conv2d

__all__ = [
    "setup_filter", "parse_padding", "parse_scaling", "filter_size",
    "upfirdn2d", "upsample2d", "downsample2d", "lrelu_agc", "conv2d",
]
