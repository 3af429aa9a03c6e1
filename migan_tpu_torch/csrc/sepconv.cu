// Fused SeparableConv2d body for Hopper (sm_90a):
//
//     z   = x [+ skip]                    or, with the prologue,
//     z   = act( (x [+ skip]) . w_pre + b_pre )            Cin -> C
//     out = [act] ( pw1x1( act( dw3x3(z) + b_dw ) ) [+ noise] )
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
//
// The options (MODE, a template argument, so the main path's kernel is
// compiled as before):
//   skip      the skip window is staged beside x in each chunk's x stage
//             and added in phase 1 before the taps;
//   prologue  z's chunk is recomputed per chunk from the input window:
//             the block's three segments of x (+ skip) with all Cin
//             channels, loaded once into shared f32 (plain loads: at
//             Cin = 4 in bf16 a pixel is 8 bytes, too few for a 16-byte
//             copy). Each thread computes act(x . w_pre + b_pre) on the
//             CUDA cores for the PPT + 2 window values of its run in each
//             of three rows, about 3 (1 + 2 / PPT) times the block's
//             pixels, Cin FMAs each: cheap at Cin <= 8, comparable to the
//             main product at Cin = 128 (PERF.md). The dw's zero padding
//             applies to z, not to x: a window pixel outside the image
//             would give act(b_pre), not 0, and the taps mask drops it,
//             as it drops every out-of-image tap. The window grows with
//             Cin; plan.py refuses a Cin whose window does not fit.
// z stays f32 up to the taps (x + skip too, which the TPU kernel adds in
// the storage type): in bfloat16 the options round only where the main
// path does, the pointwise operand and the output, where their plain
// compositions round two or three times more.
#include "pointwise_tc.cuh"

using namespace migan;
using namespace migan::tc;

namespace {
constexpr int MODE_PLAIN = 0, MODE_SKIP = 1, MODE_PROLOGUE = 2;
}  // namespace

// The stencil input of one chunk: the three flat segments of TP + 2
// pixels that hold every 3x3 tap of the block's pixels, rows h - 1, h and
// h + 1 (a tap (dy, dx) of flat pixel p is p + dy W + dx); with skip the
// skip's segments follow x's in each stage. The prologue keeps instead
// one f32 window of the segments with all Cin input channels.
template <typename T, typename G, int MODE>
struct SepX {
  static constexpr int SEG = G::TP + 2;
  static constexpr int WIN = 3 * SEG;  // window pixels
  static constexpr int NSRC = MODE == MODE_SKIP ? 2 : 1;
  static constexpr int BYTES =  // one stage
      MODE == MODE_PROLOGUE ? 0 : sizeof(T) * NSRC * WIN * KC;
  static int smem(int cin) {
    return Ring<T, G>::BYTES + (MODE == MODE_PROLOGUE
                                    ? (int)sizeof(float) * WIN * cin
                                    : 2 * BYTES);
  }
};

template <typename T, typename G, int MODE>
__global__ void __launch_bounds__(G::THREADS, G::MIN_BLOCKS)
    sepconv_kernel(const T* __restrict__ x, const T* __restrict__ skip,
                   const T* __restrict__ wpre, const T* __restrict__ bpre,
                   const T* __restrict__ wdw, const T* __restrict__ bdw,
                   const T* __restrict__ wpw, const T* __restrict__ noise,
                   T* __restrict__ out, int N, int H, int W, int Cin, int C,
                   int O, int final_act) {
  using X = SepX<T, G, MODE>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* const X0 = reinterpret_cast<T*>(smem + Ring<T, G>::BYTES);
  float* const Xp = reinterpret_cast<float*>(smem + Ring<T, G>::BYTES);
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

  // the prologue's input window, once: x (+ skip) over the three
  // segments, all Cin channels, 0 outside [0, NP) (the K loop's first
  // barrier orders these stores before phase 1)
  if constexpr (MODE == MODE_PROLOGUE) {
    for (int e = threadIdx.x; e < X::WIN * Cin; e += G::THREADS) {
      const int m = e / Cin, i = e % Cin;
      const int p = p0 + (m / X::SEG - 1) * W - 1 + m % X::SEG;
      float v = 0.f;
      if (p >= 0 && p < NP) {
        const long long a = (long long)p * Cin + i;
        v = to_f(x[a]);
        if (skip != nullptr) v += to_f(skip[a]);
      }
      Xp[e] = v;
    }
  }

  // chunk k's x (and skip) segments into x stage s; zeros outside
  // [0, NP) and past C (C is a multiple of 8, so a vector lies wholly
  // inside or outside)
  auto xload = [&](int k, int s) {
    if constexpr (MODE != MODE_PROLOGUE) {
      T* const Xs = X0 + s * XE;
      constexpr int VPP = KC / VEC;
      for (int e = threadIdx.x; e < X::NSRC * X::WIN * VPP;
           e += G::THREADS) {
        const int m = e / VPP, v = e % VPP;
        const int mw = X::NSRC == 1 ? m : m % X::WIN;
        const T* const src = X::NSRC == 1 || m < X::WIN ? x : skip;
        const int p = p0 + (mw / X::SEG - 1) * W - 1 + mw % X::SEG;
        const int gc = k * KC + v * VEC;
        const bool ok = p >= 0 && p < NP && gc < C;
        cp_async16(Xs + m * KC + v * VEC,
                   ok ? src + (long long)p * C + gc : x, ok);
      }
    }
  };

  // phase 1: A[lp][c] = act(dw3x3(z) + b_dw); a tap outside the image
  // is dropped by the taps mask
  auto phase1 = [&](int k, int s, T* As, auto&& mid) {
    const T* const Xs = X0 + s * XE;
    const int gc = k * KC + c;
    const bool cok = gc < C;
    float wk[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) wk[t] = cok ? to_f(wdw[t * C + gc]) : 0.f;
    const float b = cok ? to_f(bdw[gc]) : 0.f;
    const float bp = MODE == MODE_PROLOGUE && cok ? to_f(bpre[gc]) : 0.f;
    // a run of PPT pixels reads PPT + 2 values of each of the three rows
    float sum[PPT];
#pragma unroll
    for (int j = 0; j < PPT; ++j) sum[j] = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      float xr[PPT + 2];
      const int m0 = dy * X::SEG + q0 * PPT;
      if constexpr (MODE == MODE_PROLOGUE) {
        // z = act(x . w_pre[:, gc] + b_pre[gc]), four input channels a
        // step (Cin is a multiple of 4)
#pragma unroll
        for (int m = 0; m < PPT + 2; ++m) xr[m] = bp;
        for (int i = 0; i < Cin; i += 4) {
          float wv[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            wv[u] = cok ? to_f(wpre[(long long)(i + u) * C + gc]) : 0.f;
#pragma unroll
          for (int m = 0; m < PPT + 2; ++m) {
            const float4 xv =
                *reinterpret_cast<const float4*>(Xp + (m0 + m) * Cin + i);
            xr[m] = fmaf(xv.x, wv[0], xr[m]);
            xr[m] = fmaf(xv.y, wv[1], xr[m]);
            xr[m] = fmaf(xv.z, wv[2], xr[m]);
            xr[m] = fmaf(xv.w, wv[3], xr[m]);
          }
        }
#pragma unroll
        for (int m = 0; m < PPT + 2; ++m) xr[m] = act(xr[m]);
      } else {
#pragma unroll
        for (int m = 0; m < PPT + 2; ++m) {
          xr[m] = to_f(Xs[(m0 + m) * KC + c]);
          if constexpr (MODE == MODE_SKIP)
            xr[m] += to_f(Xs[(X::WIN + m0 + m) * KC + c]);
        }
      }
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
template <int MODE>
struct Launch {
  template <typename T, typename G>
  struct L {
    static int run(int blocks, int threads, int smem, const void* x,
                   const void* skip, const void* wpre, const void* bpre,
                   const void* wdw, const void* bdw, const void* wpw,
                   const void* noise, void* out, int N, int H, int W,
                   int Cin, int C, int O, int final_act,
                   cudaStream_t stream) {
      using X = SepX<T, G, MODE>;
      const long long tiles = ((long long)N * H * W + G::TP - 1) / G::TP;
      const bool options_ok =
          MODE == MODE_PROLOGUE
              ? (Cin % 8 == 0 || Cin == 4) && wpre != nullptr &&
                    bpre != nullptr
              : Cin == C && (MODE == MODE_PLAIN) == (skip == nullptr);
      if (threads != G::THREADS || smem != X::smem(Cin) ||
          blocks != tiles * ((O + G::TO - 1) / G::TO) || !options_ok ||
          C % 8 != 0 || O % 8 != 0)
        return (int)cudaErrorInvalidConfiguration;
      const cudaError_t err = allow_smem(sepconv_kernel<T, G, MODE>, smem);
      if (err != cudaSuccess) return (int)err;
      sepconv_kernel<T, G, MODE><<<blocks, threads, smem, stream>>>(
          (const T*)x, (const T*)skip, (const T*)wpre, (const T*)bpre,
          (const T*)wdw, (const T*)bdw, (const T*)wpw, (const T*)noise,
          (T*)out, N, H, W, Cin, C, O, final_act);
      return (int)cudaGetLastError();
    }
  };
};
}  // namespace

// dtype: 0 = float32, 1 = bfloat16; cfg, blocks, threads, smem: the launch
// plan of migan_tpu_torch/ops/kernels/plan.py, checked here; mode: 0 no
// option, 1 skip, 2 the prologue (skip optional). noise may be null; x
// (and skip) has Cin channels, Cin = C without the prologue, a multiple
// of 8 or 4 with it; C and O are multiples of 8 and N*H*W < 2^31.
// Returns the CUDA error code of the launch (0 = success).
extern "C" int migan_sepconv(int dtype, int cfg, int blocks, int threads,
                             int smem, int mode, const void* x,
                             const void* skip, const void* wpre,
                             const void* bpre, const void* wdw,
                             const void* bdw, const void* wpw,
                             const void* noise, void* out, int N, int H,
                             int W, int Cin, int C, int O, int final_act,
                             void* stream) {
#define MIGAN_SEP(M)                                                      \
  dispatch<Launch<M>::L, SepCfg0, SepCfg1, SepCfg2>(                      \
      dtype, cfg, blocks, threads, smem, x, skip, wpre, bpre, wdw, bdw, \
      wpw, noise, out, N, H, W, Cin, C, O, final_act, (cudaStream_t)stream)
  if (mode == MODE_PLAIN) return MIGAN_SEP(MODE_PLAIN);
  if (mode == MODE_SKIP) return MIGAN_SEP(MODE_SKIP);
  if (mode == MODE_PROLOGUE) return MIGAN_SEP(MODE_PROLOGUE);
#undef MIGAN_SEP
  return (int)cudaErrorInvalidValue;
}
