// Fused SeparableConv2d body for Hopper (sm_90a):
//
//     out = [act] ( pw1x1( act( dw3x3(x) + b_dw ) ) [+ noise] )
//
// Replaces two TPU kernels of migan_tpu, which compute the same function in
// two TPU layouts: migan_tpu/ops/pallas/sepconv.py:fused_block (flat rows,
// always with the final act) and migan_tpu/ops/pallas/packedblock.py:
// fused_block_packed (w-packed rows, final act optional). Here both are one
// kernel on contiguous NHWC tensors with a `final_act` flag.
//
// What bounds it on this card: the plain path makes four passes over the
// activation in device memory (dw read/write, pw read/write); at the
// main path's widths (C, O <= 512) the pointwise product is
// 2*C*O flops per pixel, so the fused kernel is bound by CUDA-core FMA issue
// at large C and by the input read at small C. The design keeps the dw
// output out of device memory entirely: phase 1 writes it to shared memory
// as f32 for the block's 64 pixels and all C channels, and phase 2
// (common.cuh) runs the pointwise product from there, so x is read once
// (plus the stencil re-reads, which hit L1/L2) and only `out` is written.
// No tensor cores yet: that is later work.
#include "common.cuh"

using namespace migan;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    sepconv_kernel(const T* __restrict__ x, const T* __restrict__ wdw,
                   const T* __restrict__ bdw, const T* __restrict__ wpw,
                   const T* __restrict__ noise, T* __restrict__ out, int N,
                   int H, int W, int C, int O, int final_act) {
  extern __shared__ __align__(16) float smem[];
  float* A = smem;
  float* Bs = smem + TP * (C + 1);
  const int CS = C + 1;
  const long long NP = (long long)N * H * W;
  const long long p0 = (long long)blockIdx.x * TP;

  // phase 1: A[lp][c] = act(dw3x3(x) + b_dw); x is zero outside the image
  for (int e = threadIdx.x; e < TP * C; e += THREADS) {
    const int lp = e / C, c = e % C;
    const long long pix = p0 + lp;
    float v = 0.f;
    if (pix < NP) {
      const int w = (int)(pix % W);
      const long long t = pix / W;
      const int h = (int)(t % H);
      const long long n = t / H;
      float s = 0.f;
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy) {
        const int hh = h + dy;
        if (hh < 0 || hh >= H) continue;
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx) {
          const int ww = w + dx;
          if (ww < 0 || ww >= W) continue;
          s = fmaf(to_f(x[((n * H + hh) * W + ww) * C + c]),
                   to_f(wdw[((dy + 1) * 3 + dx + 1) * C + c]), s);
        }
      }
      v = act(s + to_f(bdw[c]));
    }
    A[lp * CS + c] = v;
  }
  __syncthreads();

  // phase 2: pointwise product, then [+ noise] [-> act]
  const long long HW = (long long)H * W;
  pointwise<T>(A, Bs, wpw, C, O, [&](int, int lp, int o, float s) {
    const long long pix = p0 + lp;
    if (pix >= NP) return;
    if (noise != nullptr) s += to_f(noise[pix % HW]);
    if (final_act) s = act(s);
    out[pix * O + o] = from_f<T>(s);
  });
}

template <typename T>
static int launch(const void* x, const void* wdw, const void* bdw,
                  const void* wpw, const void* noise, void* out, int N, int H,
                  int W, int C, int O, int final_act, cudaStream_t stream) {
  const size_t smem = smem_bytes(C);
  cudaError_t err = allow_smem(sepconv_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long NP = (long long)N * H * W;
  const unsigned grid = (unsigned)((NP + TP - 1) / TP);
  sepconv_kernel<T><<<grid, THREADS, smem, stream>>>(
      (const T*)x, (const T*)wdw, (const T*)bdw, (const T*)wpw,
      (const T*)noise, (T*)out, N, H, W, C, O, final_act);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16. noise may be null. Returns the CUDA
// error code of the launch (0 = success).
extern "C" int migan_sepconv(int dtype, const void* x, const void* wdw,
                             const void* bdw, const void* wpw,
                             const void* noise, void* out, int N, int H,
                             int W, int C, int O, int final_act,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(x, wdw, bdw, wpw, noise, out, N, H, W, C, O,
                         final_act, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, wdw, bdw, wpw, noise, out, N, H, W, C, O,
                                 final_act, st);
  return (int)cudaErrorInvalidValue;
}
