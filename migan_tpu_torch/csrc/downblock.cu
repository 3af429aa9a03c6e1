// Fused down-sampling SeparableConv2d for Hopper (sm_90a):
//
//     y   = act( dw3x3(x) + b_dw )                       at [Hh, Wh]
//     z   = down2_[1,3,3,1](y)   (FIR pad (1,1), gain 1)  at [Hh/2, Wh/2]
//     out = act( pw1x1(z) )
//
// Replaces migan_tpu/ops/pallas/downblock.py:fused_down_block, the conv2 of
// every encoder level on the main path.
//
// What bounds it on this card: below the top level the pointwise product
// (2*C*O flops per lo-res pixel) is most of the arithmetic; at the top
// level (C = 64 -> 128) the read of the hi-res x and the stencil are. The
// plain path writes and re-reads the hi-res y in device memory and runs
// the FIR as a separate depthwise conv; here x is read once and only the
// quarter-size `out` is written. With the product on tensor cores, the
// measured bound is phase 1 on CUDA cores (the stencil over the window and
// three barriers per chunk), with one 16-warp block per SM at the large
// tiles, whose shared memory the x window and y fill (PERF.md).
//
// The design: a block owns a TH x TW tile of lo-res pixels (8 x 8, or
// 4 x 4 at the smallest shapes) and TO output channels, and streams C in
// chunks of 32 channels through the tensor-core K loop of
// pointwise_tc.cuh. The chunk's (2 TH + 4) x (2 TW + 4) hi-res x window
// arrives by cp.async, zero-filled outside [0, Hh) x [0, Wh), so the dw
// conv needs no bounds checks. Phase 1 of a chunk, as the TPU kernel does
// it (downblock.py:80-139):
//   step 1  y = act(dw3x3(x) + b_dw) once per hi-res pixel of the tile's
//           (2 TH + 2) x (2 TW + 2) window (one pixel of halo each side),
//           into shared memory; y is zero outside the image for the FIR
//           (not act(b_dw));
//   step 2  the [1,3,3,1] / 8 FIR along w, keeping every other column;
//   step 3  the same FIR along h into the A stage of the K loop.
// That is ~60 FMAs per channel and lo-res pixel (~56 of them the dw over
// the window) instead of the 144 of a per-tap recompute. The previous
// chunk's product runs on the tensor cores right after step 1, so it
// overlaps the other warps' stencil work.
//
// Trade-off of the output-channel split: each of the O / TO blocks of a
// pixel tile recomputes phase 1. With the stencil computed once per hi-res
// pixel that costs ~60 FMAs per channel per O tile against the product's
// TO multiply-adds on tensor cores; plan.py takes TO = 128 wherever a full
// wave of 132 SMs allows, and the small tiles (TO = 32) only at the
// lowest levels at batch 1, where the whole launch is a few microseconds.
#include "pointwise_tc.cuh"

using namespace migan;
using namespace migan::tc;

namespace {

// Shared memory past the ring: two stages of the x window, y over its
// inner part, and the w-filtered rows.
template <typename T, typename G>
struct Down {
  static constexpr int TH = G::TH, TW = G::TP / G::TH;
  static constexpr int XH = 2 * TH + 4, XW = 2 * TW + 4;  // x window
  static constexpr int YH = 2 * TH + 2, YW = 2 * TW + 2;  // y window
  static constexpr int X_BYTES = sizeof(T) * XH * XW * KC;  // one stage
  static constexpr int Y_BYTES = sizeof(float) * YH * YW * KC;
  static constexpr int V_BYTES = sizeof(float) * YH * TW * KC;
  static constexpr int SMEM =
      Ring<T, G>::BYTES + 2 * X_BYTES + Y_BYTES + V_BYTES;
  static_assert(TH * TW == G::TP, "tile rows must divide TP");
  static_assert(YW % 3 == 0 || YW % 2 == 0, "y rows must split in runs");
};

}  // namespace

template <typename T, typename G>
__global__ void __launch_bounds__(G::THREADS, G::MIN_BLOCKS)
    downblock_kernel(const T* __restrict__ x, const T* __restrict__ wdw,
                     const T* __restrict__ bdw, const T* __restrict__ wpw,
                     T* __restrict__ out, int N, int Hh, int Wh, int C,
                     int O) {
  using D = Down<T, G>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* const X0 = reinterpret_cast<T*>(smem + Ring<T, G>::BYTES);
  float* const Y = reinterpret_cast<float*>(smem + Ring<T, G>::BYTES +
                                            2 * D::X_BYTES);
  float* const V = Y + D::YH * D::YW * KC;
  constexpr int XE = D::X_BYTES / sizeof(T);
  constexpr int PSTEP = G::THREADS / KC;  // positions filled per pass
  constexpr int VEC = 16 / sizeof(T);     // channels per cp.async
  constexpr float F0 = 0.125f, F1 = 0.375f;
  const int Hl = Hh / 2, Wl = Wh / 2;
  const int tiles_w = (Wl + D::TW - 1) / D::TW;
  const int tiles_h = (Hl + D::TH - 1) / D::TH;
  const int OT = (O + G::TO - 1) / G::TO;
  const int o0 = (blockIdx.x % OT) * G::TO;
  int pt = blockIdx.x / OT;
  const int j0 = (pt % tiles_w) * D::TW;
  pt /= tiles_w;
  const int i0 = (pt % tiles_h) * D::TH;
  const int n = pt / tiles_h;
  const T* const xn = x + (long long)n * Hh * Wh * C;
  const int c = threadIdx.x % KC;  // this thread's channel in a chunk
  const int q0 = threadIdx.x / KC;

  // chunk k's x window into x stage s: window (r, t) is hi-res
  // (2 i0 - 2 + r, 2 j0 - 2 + t); zeros outside the image and past C
  // (C is a multiple of 8, so a vector lies wholly inside or outside)
  auto xload = [&](int k, int s) {
    T* const Xs = X0 + s * XE;
    constexpr int VPP = KC / VEC;
    for (int e = threadIdx.x; e < D::XH * D::XW * VPP; e += G::THREADS) {
      const int m = e / VPP, v = e % VPP;
      const int h = 2 * i0 - 2 + m / D::XW, w = 2 * j0 - 2 + m % D::XW;
      const int gc = k * KC + v * VEC;
      const bool ok = h >= 0 && h < Hh && w >= 0 && w < Wh && gc < C;
      cp_async16(Xs + m * KC + v * VEC,
                 ok ? xn + ((long long)h * Wh + w) * C + gc : x, ok);
    }
  };

  auto phase1 = [&](int k, int s, T* As, auto&& mid) {
    const T* const Xs = X0 + s * XE;
    const int gc = k * KC + c;
    const bool cok = gc < C;
    float wk[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) wk[t] = cok ? to_f(wdw[t * C + gc]) : 0.f;
    const float b = cok ? to_f(bdw[gc]) : 0.f;
    // step 1: y = act(dw3x3(x) + b_dw) once per hi-res pixel of the y
    // window, (r, t) at hi-res (2 i0 - 1 + r, 2 j0 - 1 + t); 0 outside
    // the image. A thread takes runs of RL pixels along a row, which
    // read RL + 2 values of each of three x rows.
    constexpr int RL = D::YW % 3 == 0 ? D::YW / 3 : D::YW / 2;
    constexpr int RPR = D::YW / RL;  // runs per row
    for (int u = q0; u < D::YH * RPR; u += PSTEP) {
      const int r = u / RPR, t0 = (u % RPR) * RL;
      float sum[RL];
#pragma unroll
      for (int j = 0; j < RL; ++j) sum[j] = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float xr[RL + 2];
#pragma unroll
        for (int m = 0; m < RL + 2; ++m)
          xr[m] = to_f(Xs[((r + dy) * D::XW + t0 + m) * KC + c]);
#pragma unroll
        for (int j = 0; j < RL; ++j)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
            sum[j] = fmaf(xr[j + dx], wk[dy * 3 + dx], sum[j]);
      }
      const int h = 2 * i0 - 1 + r;
      const bool hin = cok && h >= 0 && h < Hh;
#pragma unroll
      for (int j = 0; j < RL; ++j) {
        const int w = 2 * j0 - 1 + t0 + j;
        Y[(r * D::YW + t0 + j) * KC + c] =
            hin && w >= 0 && w < Wh ? act(sum[j] + b) : 0.f;
      }
    }
    mid();
    __syncthreads();
    // step 2: along w, V[r][j] = FIR(Y[r][2j .. 2j + 3])
    for (int q = q0; q < D::YH * D::TW; q += PSTEP) {
      const int r = q / D::TW, j = q % D::TW;
      const float* y = Y + (r * D::YW + 2 * j) * KC + c;
      V[q * KC + c] = F0 * y[0] + F1 * y[KC] + F1 * y[2 * KC] + F0 * y[3 * KC];
    }
    __syncthreads();
    // step 3: along h, A[i TW + j] = FIR(V[2i .. 2i + 3][j])
    for (int q = q0; q < G::TP; q += PSTEP) {
      const int i = q / D::TW, j = q % D::TW;
      const float* v = V + (2 * i * D::TW + j) * KC + c;
      constexpr int RS = D::TW * KC;  // one V row
      As[q * Ring<T, G>::KS + c] = from_f<T>(
          F0 * v[0] + F1 * v[RS] + F1 * v[2 * RS] + F0 * v[3 * RS]);
    }
  };

  Acc<G> acc;
  k_loop<T, G>(acc, smem, wpw, C, O, o0, xload, phase1);

  // epilogue: act, two adjacent channels per store
  for_each_pair<G>(acc, [&](int lp, int o, float s0, float s1) {
    const int i = i0 + lp / D::TW, j = j0 + lp % D::TW, go = o0 + o;
    if (i >= Hl || j >= Wl || go >= O) return;
    store2(out + (((long long)n * Hl + i) * Wl + j) * O + go, act(s0),
           act(s1));
  });
}

namespace {
template <typename T, typename G>
struct Launch {
  static int run(int blocks, int threads, int smem, const void* x,
                 const void* wdw, const void* bdw, const void* wpw,
                 void* out, int N, int Hh, int Wh, int C, int O,
                 cudaStream_t stream) {
    using D = Down<T, G>;
    const long long tiles = (long long)N * ((Hh / 2 + D::TH - 1) / D::TH) *
                            ((Wh / 2 + D::TW - 1) / D::TW);
    if (threads != G::THREADS || smem != D::SMEM ||
        blocks != tiles * ((O + G::TO - 1) / G::TO) || C % 8 != 0 ||
        O % 8 != 0)
      return (int)cudaErrorInvalidConfiguration;
    const cudaError_t err = allow_smem(downblock_kernel<T, G>, smem);
    if (err != cudaSuccess) return (int)err;
    downblock_kernel<T, G><<<blocks, threads, smem, stream>>>(
        (const T*)x, (const T*)wdw, (const T*)bdw, (const T*)wpw, (T*)out, N,
        Hh, Wh, C, O);
    return (int)cudaGetLastError();
  }
};
}  // namespace

// dtype: 0 = float32, 1 = bfloat16; cfg, blocks, threads, smem: the launch
// plan of migan_tpu_torch/ops/kernels/plan.py, checked here. Hh and Wh are
// even; C and O are multiples of 8. Returns the CUDA error code of the launch
// (0 = success).
extern "C" int migan_downblock(int dtype, int cfg, int blocks, int threads,
                               int smem, const void* x, const void* wdw,
                               const void* bdw, const void* wpw, void* out,
                               int N, int Hh, int Wh, int C, int O,
                               void* stream) {
  return dispatch<Launch, DownCfg0, DownCfg1, DownCfg2>(
      dtype, cfg, blocks, threads, smem, x, wdw, bdw, wpw, out, N, Hh, Wh, C,
      O, (cudaStream_t)stream);
}
