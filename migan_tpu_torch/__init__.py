"""MI-GAN in PyTorch for NVIDIA Hopper: the port of `migan_tpu`.

The package mirrors `migan_tpu`'s module names. Plain tensor code is
PyTorch; the four Pallas kernels of `migan_tpu` are hand-written CUDA C++
kernels for sm_90a (`csrc/`), built with nvcc at first use and bound with
ctypes (`ops/kernels/`).

- Public tensors keep JAX's NHWC layout: the generator takes [N, H, W, 4]
  and returns [N, H, W, 3].
- Weights are an `nn.Module` whose parameter paths read like the JAX
  pytree (`encoder.b512.conv1.conv1.weight`, ...), in torch's OIHW layout.
- On a CPU tensor every fused op runs its plain PyTorch version; on a CUDA
  tensor it launches its kernel or raises.

Importing this package imports nothing else.
"""

__version__ = "0.1.0"
