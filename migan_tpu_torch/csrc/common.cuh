// Shared pieces of the MI-GAN Hopper kernels (sepconv.cu, downblock.cu,
// upblock.cu).
//
// Every kernel here has the same shape: a thread block owns a tile of
// TP = 64 output pixels (consecutive in the flat N*H*W order of a
// contiguous NHWC tensor) and runs two phases.
//
//   phase 1  the kernel's own stencil work (depthwise 3x3, FIR taps,
//            noise, activation) for all C channels of the tile, written
//            as f32 into shared memory A[TP][C + 1];
//   phase 2  the pointwise 1x1 as a [TP, C] x [C, O] product on CUDA-core
//            FMAs, in output tiles of TO = 64 channels; the weight rows
//            are staged through shared memory KC = 32 at a time, and each
//            of the 256 threads keeps a 4 x 4 register tile of sums.
//
// Storage is float or __nv_bfloat16; all arithmetic is f32, as in the TPU
// kernels. A's row stride C + 1 is odd, so the phase-1 stores (consecutive
// channels) and the phase-2 loads (four pixel rows per thread) fall in
// distinct shared-memory banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace migan {

constexpr int TP = 64;        // output pixels per block
constexpr int TO = 64;        // output channels per phase-2 pass
constexpr int KC = 32;        // weight rows staged per step
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

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

// Shared memory a block asks for: A plus the staged weight rows.
inline size_t smem_bytes(int C) {
  return sizeof(float) * ((size_t)TP * (C + 1) + (size_t)KC * TO);
}

// Raise the kernel's dynamic shared-memory limit when it needs > 48 KB.
// A C too large for a block (> 227 KB) fails here; the error is returned
// and cleared, so the next launch does not report it again.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

// Phase 2. A: [TP][C + 1] f32 in shared memory, filled by phase 1 and
// followed by a [KC][TO] staging area. Wp: [C][O] storage-typed weights.
// For every output tile the epilogue gets (i, local pixel, channel o, sum)
// for the 4 x 4 sums a thread owns, local pixels 4 ty + i in order i.
template <typename T, typename Epi>
__device__ __forceinline__ void pointwise(const float* A, float* Bs,
                                          const T* __restrict__ Wp, int C,
                                          int O, Epi epi) {
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output channels o0 + 4 tx .. + 3
  const int ty = tid / 16;  // local pixels 4 ty .. + 3
  const int CS = C + 1;
  for (int o0 = 0; o0 < O; o0 += TO) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < C; k0 += KC) {
      for (int e = tid; e < KC * TO; e += THREADS) {
        const int k = e / TO, o = e % TO;
        const int gk = k0 + k, go = o0 + o;
        Bs[e] = (gk < C && go < O) ? to_f(Wp[(size_t)gk * O + go]) : 0.f;
      }
      __syncthreads();
      const int kn = min(KC, C - k0);
      for (int k = 0; k < kn; ++k) {
        const float4 b = *reinterpret_cast<const float4*>(&Bs[k * TO + tx * 4]);
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = A[(ty * 4 + i) * CS + k0 + k];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][0] = fmaf(a[i], b.x, acc[i][0]);
          acc[i][1] = fmaf(a[i], b.y, acc[i][1]);
          acc[i][2] = fmaf(a[i], b.z, acc[i][2]);
          acc[i][3] = fmaf(a[i], b.w, acc[i][3]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = o0 + tx * 4 + j;
        if (o < O) epi(i, ty * 4 + i, o, acc[i][j]);
      }
  }
}

}  // namespace migan
