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
// What bounds it on this card: the pointwise product is 2*C*O flops per
// pixel against 9 FMAs per channel for the depthwise stencil, so at
// C >= 128 the product is most of the arithmetic, and at C = 64 the x read
// and out write (the plain path makes four passes over device memory) are
// most of the bytes. With the product on tensor cores, the measured bound
// in bfloat16 is the CUDA-core work around it: phase 1's shared-memory
// loads and FMAs, repeated for each output tile, and one barrier per
// chunk. In float32 the three TF32 products and their hi/lo splits take
// about half of the time at C >= 128 (PERF.md).
//
// The design: the dw output never reaches device memory. A block owns
// TP = 64 (or 16) consecutive pixels of the flat N*H*W order and TO = 128,
// 64 (or 32) output channels, and streams C through shared memory in
// chunks of 32 channels (pointwise_tc.cuh): the chunk's x (three flat
// segments of TP + 2 pixels: rows h - 1, h, h + 1 of every tap) and its
// weights arrive by cp.async, phase 1 writes act(dw3x3 + b) of the next
// chunk into the A ring from there (each thread a run of consecutive
// pixels, so a run of R pixels reads 3 (R + 2) values, not 9 R), and the
// tensor cores (mma.sync; bf16, or three TF32 products for float32)
// consume the current chunk. Shared memory is 14-102 KB whatever C, so
// two or more blocks share an SM.
//
// Trade-off of the output-channel split: each of the O / TO blocks of a
// pixel tile recomputes phase 1 (9 FMAs per channel and pixel), the work
// that now bounds the kernel; it buys enough blocks for 132 SMs at the
// low levels at batch 1. plan.py picks the largest tile that still gives
// a full wave, and orders the blocks output-tile first so that the blocks
// that read the same x run together and share it through L2.
#include "pointwise_tc.cuh"

using namespace migan;
using namespace migan::tc;

// The stencil input of one chunk: the three flat segments of TP + 2
// pixels that hold every 3x3 tap of the block's pixels, rows h - 1, h and
// h + 1 (a tap (dy, dx) of flat pixel p is p + dy W + dx).
template <typename T, typename G>
struct SepX {
  static constexpr int SEG = G::TP + 2;
  static constexpr int BYTES = sizeof(T) * 3 * SEG * KC;  // one stage
  static constexpr int SMEM = Ring<T, G>::BYTES + 2 * BYTES;
};

template <typename T, typename G>
__global__ void __launch_bounds__(G::THREADS, G::MIN_BLOCKS)
    sepconv_kernel(const T* __restrict__ x, const T* __restrict__ wdw,
                   const T* __restrict__ bdw, const T* __restrict__ wpw,
                   const T* __restrict__ noise, T* __restrict__ out, int N,
                   int H, int W, int C, int O, int final_act) {
  using X = SepX<T, G>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* const X0 = reinterpret_cast<T*>(smem + Ring<T, G>::BYTES);
  constexpr int XE = X::BYTES / sizeof(T);
  constexpr int PPT = G::TP / (G::THREADS / KC);  // pixels per thread
  constexpr int VEC = 16 / sizeof(T);     // channels per cp.async
  const int NP = N * H * W;
  const int OT = (O + G::TO - 1) / G::TO;
  const int o0 = (blockIdx.x % OT) * G::TO;
  const int p0 = (blockIdx.x / OT) * G::TP;
  const int c = threadIdx.x % KC;  // this thread's channel in a chunk
  const int q0 = threadIdx.x / KC;

  // This thread's pixels p0 + q0 PPT + j, a run of PPT consecutive
  // pixels: the taps (dy + 1) * 3 + dx + 1 inside the image as bits 0-8,
  // and bit 9 set when the pixel exists.
  unsigned taps[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int p = p0 + q0 * PPT + j;
    taps[j] = 0;
    if (p < NP) {
      const int w = p % W, h = (p / W) % H;
      unsigned m = 1u << 9;
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx)
          if (h + dy >= 0 && h + dy < H && w + dx >= 0 && w + dx < W)
            m |= 1u << ((dy + 1) * 3 + dx + 1);
      taps[j] = m;
    }
  }

  // chunk k's x segments into x stage s; zeros outside [0, NP) and past C
  // (C is a multiple of 8, so a vector lies wholly inside or outside)
  auto xload = [&](int k, int s) {
    T* const Xs = X0 + s * XE;
    constexpr int VPP = KC / VEC;
    for (int e = threadIdx.x; e < 3 * X::SEG * VPP; e += G::THREADS) {
      const int m = e / VPP, v = e % VPP;
      const int p = p0 + (m / X::SEG - 1) * W - 1 + m % X::SEG;
      const int gc = k * KC + v * VEC;
      const bool ok = p >= 0 && p < NP && gc < C;
      cp_async16(Xs + m * KC + v * VEC, ok ? x + (long long)p * C + gc : x,
                 ok);
    }
  };

  // phase 1: A[lp][c] = act(dw3x3(x) + b_dw); x is zero outside the image
  auto phase1 = [&](int k, int s, T* As, auto&& mid) {
    const T* const Xs = X0 + s * XE;
    const int gc = k * KC + c;
    const bool cok = gc < C;
    float wk[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) wk[t] = cok ? to_f(wdw[t * C + gc]) : 0.f;
    const float b = cok ? to_f(bdw[gc]) : 0.f;
    // a run of PPT pixels reads PPT + 2 values of each of the three rows
    float sum[PPT];
#pragma unroll
    for (int j = 0; j < PPT; ++j) sum[j] = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      float xr[PPT + 2];
#pragma unroll
      for (int m = 0; m < PPT + 2; ++m)
        xr[m] = to_f(Xs[(dy * X::SEG + q0 * PPT + m) * KC + c]);
#pragma unroll
      for (int j = 0; j < PPT; ++j)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          sum[j] = fmaf((taps[j] >> (dy * 3 + dx)) & 1u ? xr[j + dx] : 0.f,
                        wk[dy * 3 + dx], sum[j]);
    }
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const float v = cok && (taps[j] >> 9) ? act(sum[j] + b) : 0.f;
      As[(q0 * PPT + j) * Ring<T, G>::KS + c] = from_f<T>(v);
    }
    mid();
  };

  Acc<G> acc;
  k_loop<T, G>(acc, smem, wpw, C, O, o0, xload, phase1);

  // epilogue: [+ noise] [-> act], two adjacent channels per store
  const int HW = H * W;
  for_each_pair<G>(acc, [&](int lp, int o, float s0, float s1) {
    const int p = p0 + lp, go = o0 + o;
    if (p >= NP || go >= O) return;
    if (noise != nullptr) {
      const float nz = to_f(noise[p % HW]);
      s0 += nz;
      s1 += nz;
    }
    if (final_act) {
      s0 = act(s0);
      s1 = act(s1);
    }
    store2(out + (long long)p * O + go, s0, s1);
  });
}

namespace {
template <typename T, typename G>
struct Launch {
  static int run(int blocks, int threads, int smem, const void* x,
                 const void* wdw, const void* bdw, const void* wpw,
                 const void* noise, void* out, int N, int H, int W, int C,
                 int O, int final_act, cudaStream_t stream) {
    const long long tiles = ((long long)N * H * W + G::TP - 1) / G::TP;
    if (threads != G::THREADS || smem != SepX<T, G>::SMEM ||
        blocks != tiles * ((O + G::TO - 1) / G::TO) || C % 8 != 0 ||
        O % 8 != 0)
      return (int)cudaErrorInvalidConfiguration;
    const cudaError_t err = allow_smem(sepconv_kernel<T, G>, smem);
    if (err != cudaSuccess) return (int)err;
    sepconv_kernel<T, G><<<blocks, threads, smem, stream>>>(
        (const T*)x, (const T*)wdw, (const T*)bdw, (const T*)wpw,
        (const T*)noise, (T*)out, N, H, W, C, O, final_act);
    return (int)cudaGetLastError();
  }
};
}  // namespace

// dtype: 0 = float32, 1 = bfloat16; cfg, blocks, threads, smem: the launch
// plan of migan_tpu_torch/ops/kernels/plan.py, checked here. noise may be
// null; C and O are multiples of 8 and N*H*W < 2^31. Returns the CUDA
// error code of the launch (0 = success).
extern "C" int migan_sepconv(int dtype, int cfg, int blocks, int threads,
                             int smem, const void* x, const void* wdw,
                             const void* bdw, const void* wpw,
                             const void* noise, void* out, int N, int H,
                             int W, int C, int O, int final_act,
                             void* stream) {
  return dispatch<Launch, SepCfg0, SepCfg1, SepCfg2>(
      dtype, cfg, blocks, threads, smem, x, wdw, bdw, wpw, noise, out, N, H,
      W, C, O, final_act, (cudaStream_t)stream);
}
