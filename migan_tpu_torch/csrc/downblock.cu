// Fused down-sampling SeparableConv2d for Hopper (sm_90a):
//
//     y   = act( dw3x3(x) + b_dw )                       at [Hh, Wh]
//     z   = down2_[1,3,3,1](y)   (FIR pad (1,1), gain 1)  at [Hh/2, Wh/2]
//     out = act( pw1x1(z) )
//
// Replaces migan_tpu/ops/pallas/downblock.py:fused_down_block, the conv2 of
// every encoder level on the main path.
//
// What bounds it on this card: the plain path writes and re-reads the
// hi-res y in device memory and runs the FIR as a separate depthwise conv;
// here x is read once and only the quarter-size `out` is written. Per
// lo-res pixel and channel the kernel evaluates the 16 y taps of the FIR
// window directly (9 FMAs each), so the hi-res stencil is recomputed about
// 4x: at the top level (C = 64, O = 128) this CUDA-core work, not device
// memory, is the bound. The design keeps z out of device memory (phase 1
// writes it to shared memory, phase 2 in common.cuh runs the pointwise
// product from there) and takes the zero padding exactly as the plain
// path does: x is zero outside [0, Hh) x [0, Wh) for the dw conv, and y
// is zero outside it for the FIR (not act(b_dw)).
#include "common.cuh"

using namespace migan;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    downblock_kernel(const T* __restrict__ x, const T* __restrict__ wdw,
                     const T* __restrict__ bdw, const T* __restrict__ wpw,
                     T* __restrict__ out, int N, int Hh, int Wh, int C,
                     int O) {
  extern __shared__ __align__(16) float smem[];
  float* A = smem;
  float* Bs = smem + TP * (C + 1);
  const int CS = C + 1;
  const int Hl = Hh / 2, Wl = Wh / 2;
  const long long NP = (long long)N * Hl * Wl;
  const long long p0 = (long long)blockIdx.x * TP;
  const float fir[4] = {0.125f, 0.375f, 0.375f, 0.125f};

  // phase 1: A[lp][c] = sum_ab fir[a] fir[b] y(2i-1+a, 2j-1+b, c)
  for (int e = threadIdx.x; e < TP * C; e += THREADS) {
    const int lp = e / C, c = e % C;
    const long long pix = p0 + lp;
    float z = 0.f;
    if (pix < NP) {
      const int j = (int)(pix % Wl);
      const long long t = pix / Wl;
      const int i = (int)(t % Hl);
      const long long n = t / Hl;
      float wk[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) wk[k] = to_f(wdw[k * C + c]);
      const float b = to_f(bdw[c]);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int h = 2 * i - 1 + a;
        if (h < 0 || h >= Hh) continue;
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          const int w = 2 * j - 1 + bb;
          if (w < 0 || w >= Wh) continue;
          float s = 0.f;
#pragma unroll
          for (int dy = -1; dy <= 1; ++dy) {
            const int hh = h + dy;
            if (hh < 0 || hh >= Hh) continue;
#pragma unroll
            for (int dx = -1; dx <= 1; ++dx) {
              const int ww = w + dx;
              if (ww < 0 || ww >= Wh) continue;
              s = fmaf(to_f(x[((n * Hh + hh) * Wh + ww) * C + c]),
                       wk[(dy + 1) * 3 + dx + 1], s);
            }
          }
          z = fmaf(fir[a] * fir[bb], act(s + b), z);
        }
      }
    }
    A[lp * CS + c] = z;
  }
  __syncthreads();

  // phase 2: pointwise product -> act
  pointwise<T>(A, Bs, wpw, C, O, [&](int, int lp, int o, float s) {
    const long long pix = p0 + lp;
    if (pix < NP) out[pix * O + o] = from_f<T>(act(s));
  });
}

template <typename T>
static int launch(const void* x, const void* wdw, const void* bdw,
                  const void* wpw, void* out, int N, int Hh, int Wh, int C,
                  int O, cudaStream_t stream) {
  const size_t smem = smem_bytes(C);
  cudaError_t err = allow_smem(downblock_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long NP = (long long)N * (Hh / 2) * (Wh / 2);
  const unsigned grid = (unsigned)((NP + TP - 1) / TP);
  downblock_kernel<T><<<grid, THREADS, smem, stream>>>(
      (const T*)x, (const T*)wdw, (const T*)bdw, (const T*)wpw, (T*)out, N,
      Hh, Wh, C, O);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16; Hh and Wh even. Returns the CUDA error
// code of the launch (0 = success).
extern "C" int migan_downblock(int dtype, const void* x, const void* wdw,
                               const void* bdw, const void* wpw, void* out,
                               int N, int Hh, int Wh, int C, int O,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(x, wdw, bdw, wpw, out, N, Hh, Wh, C, O, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, wdw, bdw, wpw, out, N, Hh, Wh, C, O, st);
  return (int)cudaErrorInvalidValue;
}
