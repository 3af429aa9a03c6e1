// Shared pieces of the MI-GAN Hopper kernels (sepconv.cu, downblock.cu,
// upblock.cu): storage conversions, the model's activation and the
// dynamic shared-memory opt-in.
//
// Storage is float or __nv_bfloat16; stencil arithmetic is f32, as in the
// TPU kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace migan {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

// lrelu_agc(alpha=0.2, gain=sqrt 2, clamp=256): the model's one activation.
__device__ __forceinline__ float act(float v) {
  v = v >= 0.f ? v : v * 0.2f;
  v *= 1.41421356237309515f;
  return fminf(fmaxf(v, -256.f), 256.f);
}

// Raise the kernel's dynamic shared-memory limit when it needs > 48 KB.
// A size too large for a block (> 227 KB) fails here; the error is
// returned and cleared, so the next launch does not report it again.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

}  // namespace migan
