"""Op layer of the port: resampling, the activations, plain convs and the
resampling conv of the training nets, and the hand-written CUDA kernels
(`ops.kernels`)."""

from .filters import setup_filter, parse_padding, parse_scaling, filter_size
from .upfirdn2d import downsample2d, filter2d, upfirdn2d, upsample2d
from .bias_act import activation_funcs, bias_act, get_unit, lrelu_agc
from .conv import conv2d, conv2d_resample

__all__ = [
    "setup_filter", "parse_padding", "parse_scaling", "filter_size",
    "upfirdn2d", "upsample2d", "downsample2d", "filter2d",
    "activation_funcs",
    "bias_act", "get_unit", "lrelu_agc", "conv2d", "conv2d_resample",
]
