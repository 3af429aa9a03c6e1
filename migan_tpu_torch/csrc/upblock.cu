// Fused up-sampling synthesis block for Hopper (sm_90a):
//
//     t    = act( up2_[1,3,3,1](x_lo) + noise_up ) + skip       at [Hh, Wh]
//     feat = act( pw1x1( act( dw3x3(t) + b_dw ) ) [+ noise2] )
//     rgb  = feat . w_rgb + b_rgb                               (optional)
//
// Replaces migan_tpu/ops/pallas/upblock.py:fused_up_block, the hi-res half
// of every synthesis level on the main path, with its torgb epilogue; at
// the top level the features are not stored at all (feat == null).
//
// What bounds it on this card: the plain path makes about eight passes
// over the hi-res activation (up-sample, noise, act, skip add, dw, act, pw,
// noise, act, torgb); here x_lo and skip are read once, and only feat
// and/or the 3-channel rgb are written, so the least time is the bytes of
// x_lo, skip and the outputs at the top level, and the pointwise product
// (2*C*O flops per hi-res pixel) at C = 512.
//
// The design: a block owns a TH x TW tile of hi-res pixels (8 x 8, or
// 4 x 4 at the smallest shapes) and TO output channels, and streams C in
// chunks of 32 channels through the tensor-core K loop of
// pointwise_tc.cuh. Per chunk, the matching (TH/2 + 2) x (TW/2 + 2) x_lo
// window and (TH + 2) x (TW + 2) skip window arrive by cp.async, a chunk
// ahead, zero-filled outside the image. Phase 1 of a chunk:
//   step 1  t once per hi-res pixel of the (TH + 2) x (TW + 2) window (one
//           pixel of halo each side) into shared f32, from the separable
//           0.75 / 0.25 taps along w, then along h; t is 0 outside the
//           image, as the dw conv's zero padding sees it (not act(noise) +
//           skip). The up-sample sees x_lo = 0 outside its range (out[2k] =
//           .75 x[k] + .25 x[k-1], out[2k+1] = .75 x[k] + .25 x[k+1] per
//           axis), which the zero-filled window gives;
//   step 2  act(dw3x3(t) + b_dw) into the A stage of the K loop (rounded
//           to bf16 in bf16, as the TPU kernels round the pointwise input).
// Per output pixel and channel that is 1.56 t values (one x_lo, one skip
// and one noise load from shared memory each) and 3.75 t loads for the dw,
// where re-deriving t for each of the 9 taps would take 36 x_lo loads.
//
// torgb: rgb sums over all O channels, which the output-channel split
// spreads over O / TO blocks. Each block sums its TO channels in a fixed
// order (the four lanes of a pixel row by shuffles, then its WN warps
// through shared memory); with one output tile it writes rgb itself, else
// it writes its partial sums to a [O/TO, N*Hh*Wh, 3] f32 scratch and a
// second small launch adds them in output-tile order. No float atomics, so
// rgb is the same from run to run.
#include "pointwise_tc.cuh"

using namespace migan;
using namespace migan::tc;

namespace {

constexpr int CR = 3;  // rgb channels

// Shared memory past the ring: two stages of the x_lo and skip windows,
// t over its window (f32), and noise_up over the same window.
template <typename T, typename G>
struct Up {
  static constexpr int TH = G::TH, TW = G::TP / G::TH;
  static constexpr int XH = TH / 2 + 2, XW = TW / 2 + 2;  // x_lo window
  static constexpr int SH = TH + 2, SW = TW + 2;          // t, skip window
  static constexpr int XPIX = XH * XW, SPIX = SH * SW;
  static constexpr int STAGE_BYTES = sizeof(T) * (XPIX + SPIX) * KC;
  static constexpr int T_BYTES = sizeof(float) * SPIX * KC;
  static constexpr int NZ_BYTES = sizeof(float) * SPIX;
  static constexpr int SMEM =
      Ring<T, G>::BYTES + 2 * STAGE_BYTES + T_BYTES + NZ_BYTES;
  static_assert(TH % 2 == 0 && TW % 2 == 0 && TH * TW == G::TP,
                "tiles start on even hi-res rows and columns");
  static_assert(sizeof(float) * G::TP * G::WN * CR <= Ring<T, G>::BYTES,
                "the rgb sums reuse the ring");
};

}  // namespace

template <typename T, typename G>
__global__ void __launch_bounds__(G::THREADS, G::MIN_BLOCKS)
    upblock_kernel(const T* __restrict__ x, const T* __restrict__ skip,
                   const T* __restrict__ noise_up, const T* __restrict__ wdw,
                   const T* __restrict__ bdw, const T* __restrict__ wpw,
                   const T* __restrict__ noise2, const T* __restrict__ wrgb,
                   const T* __restrict__ brgb, T* __restrict__ feat,
                   T* __restrict__ rgb, float* __restrict__ part, int N,
                   int Hl, int Wl, int C, int O) {
  using U = Up<T, G>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* const S0 = reinterpret_cast<T*>(smem + Ring<T, G>::BYTES);
  float* const Tw = reinterpret_cast<float*>(smem + Ring<T, G>::BYTES +
                                             2 * U::STAGE_BYTES);
  float* const Nz = Tw + U::SPIX * KC;
  constexpr int SE = U::STAGE_BYTES / sizeof(T);
  constexpr int PSTEP = G::THREADS / KC;  // positions filled per pass
  constexpr int VEC = 16 / sizeof(T);     // channels per cp.async
  const int Hh = 2 * Hl, Wh = 2 * Wl;
  const long long NP = (long long)N * Hh * Wh;
  const int tiles_w = (Wh + U::TW - 1) / U::TW;
  const int tiles_h = (Hh + U::TH - 1) / U::TH;
  const int OT = (O + G::TO - 1) / G::TO;
  const int ot = blockIdx.x % OT;
  const int o0 = ot * G::TO;
  int pt = blockIdx.x / OT;
  const int w0 = (pt % tiles_w) * U::TW;
  pt /= tiles_w;
  const int h0 = (pt % tiles_h) * U::TH;
  const int n = pt / tiles_h;
  const T* const xn = x + (long long)n * Hl * Wl * C;
  const T* const sn = skip + (long long)n * Hh * Wh * C;
  const int c = threadIdx.x % KC;  // this thread's channel in a chunk
  const int q0 = threadIdx.x / KC;

  // noise_up over the t window, once (the K loop's first barrier orders
  // these stores before phase 1)
  for (int m = threadIdx.x; m < U::SPIX; m += G::THREADS) {
    const int h = h0 - 1 + m / U::SW, w = w0 - 1 + m % U::SW;
    Nz[m] = h >= 0 && h < Hh && w >= 0 && w < Wh
                ? to_f(noise_up[h * Wh + w])
                : 0.f;
  }

  // chunk k's windows into stage s: x_lo window (r, q) is lo-res
  // (h0/2 - 1 + r, w0/2 - 1 + q), then skip window (r, q) is hi-res
  // (h0 - 1 + r, w0 - 1 + q); zeros outside the image and past C (C is a
  // multiple of 8, so a vector lies wholly inside or outside)
  auto xload = [&](int k, int s) {
    T* const Xs = S0 + s * SE;
    constexpr int VPP = KC / VEC;
    for (int e = threadIdx.x; e < (U::XPIX + U::SPIX) * VPP;
         e += G::THREADS) {
      const int m = e / VPP, gc = k * KC + (e % VPP) * VEC;
      const T* src = x;
      bool ok = false;
      if (m < U::XPIX) {
        const int h = h0 / 2 - 1 + m / U::XW, w = w0 / 2 - 1 + m % U::XW;
        ok = h >= 0 && h < Hl && w >= 0 && w < Wl && gc < C;
        if (ok) src = xn + ((long long)h * Wl + w) * C + gc;
      } else {
        const int ms = m - U::XPIX;
        const int h = h0 - 1 + ms / U::SW, w = w0 - 1 + ms % U::SW;
        ok = h >= 0 && h < Hh && w >= 0 && w < Wh && gc < C;
        if (ok) src = sn + ((long long)h * Wh + w) * C + gc;
      }
      cp_async16(Xs + m * KC + (e % VPP) * VEC, src, ok);
    }
  };

  auto phase1 = [&](int k, int s, T* As, auto&& mid) {
    const T* const Xs = S0 + s * SE;
    const T* const Ss = Xs + U::XPIX * KC;
    const int gc = k * KC + c;
    const bool cok = gc < C;
    // step 1: t over the window in 2 x 2 units. Unit (i, j) is window rows
    // 2i, 2i + 1 and columns 2j, 2j + 1, from x_lo window rows i, i + 1 and
    // columns j, j + 1: window row 2i is hi-res row h0 - 1 + 2i (odd), so
    // .75 x[i] + .25 x[i + 1]; row 2i + 1 (even) .75 x[i + 1] + .25 x[i];
    // the same along w.
    constexpr int UW = U::TW / 2 + 1;
    for (int u = q0; u < (U::TH / 2 + 1) * UW; u += PSTEP) {
      const int i = u / UW, j = u % UW;
      float lw[2], rw[2];  // along w: columns 2j and 2j + 1, x rows i, i + 1
#pragma unroll
      for (int di = 0; di < 2; ++di) {
        const T* xr = Xs + ((i + di) * U::XW + j) * KC + c;
        const float x0 = to_f(xr[0]), x1 = to_f(xr[KC]);
        lw[di] = fmaf(0.75f, x0, 0.25f * x1);
        rw[di] = fmaf(0.75f, x1, 0.25f * x0);
      }
      float up[2][2];  // [row 2i + dr][column 2j + dq]
      up[0][0] = fmaf(0.75f, lw[0], 0.25f * lw[1]);
      up[1][0] = fmaf(0.75f, lw[1], 0.25f * lw[0]);
      up[0][1] = fmaf(0.75f, rw[0], 0.25f * rw[1]);
      up[1][1] = fmaf(0.75f, rw[1], 0.25f * rw[0]);
#pragma unroll
      for (int dr = 0; dr < 2; ++dr)
#pragma unroll
        for (int dq = 0; dq < 2; ++dq) {
          const int r = 2 * i + dr, q = 2 * j + dq, m = r * U::SW + q;
          const int h = h0 - 1 + r, w = w0 - 1 + q;
          Tw[m * KC + c] = h >= 0 && h < Hh && w >= 0 && w < Wh
                               ? act(up[dr][dq] + Nz[m]) +
                                     to_f(Ss[m * KC + c])
                               : 0.f;
        }
    }
    mid();
    __syncthreads();
    // step 2: A = act(dw3x3(t) + b_dw), a row of TW pixels per thread,
    // which reads TW + 2 values of each of three t rows
    float wk[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) wk[t] = cok ? to_f(wdw[t * C + gc]) : 0.f;
    const float b = cok ? to_f(bdw[gc]) : 0.f;
    for (int r = q0; r < U::TH; r += PSTEP) {
      float sum[U::TW];
#pragma unroll
      for (int j = 0; j < U::TW; ++j) sum[j] = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float tr[U::TW + 2];
#pragma unroll
        for (int m = 0; m < U::TW + 2; ++m)
          tr[m] = Tw[((r + dy) * U::SW + m) * KC + c];
#pragma unroll
        for (int j = 0; j < U::TW; ++j)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
            sum[j] = fmaf(tr[j + dx], wk[dy * 3 + dx], sum[j]);
      }
#pragma unroll
      for (int j = 0; j < U::TW; ++j)
        As[(r * U::TW + j) * Ring<T, G>::KS + c] =
            from_f<T>(cok ? act(sum[j] + b) : 0.f);
    }
  };

  Acc<G> acc;
  k_loop<T, G>(acc, smem, wpw, C, O, o0, xload, phase1);

  // epilogue: [+ noise2] -> act -> feat, two adjacent channels per store;
  // each thread sums feat . w_rgb over its channels for each of its rows
  const int lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const int m0 = warp_m0<G>(), n0 = warp_n0<G>();
  float rp[G::MI][2][CR];
#pragma unroll
  for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
      for (int r = 0; r < CR; ++r) rp[mi][h2][r] = 0.f;
#pragma unroll
  for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int lp = m0 + mi * 16 + g + 8 * h2;
      const int i = h0 + lp / U::TW, j = w0 + lp % U::TW;
      if (i >= Hh || j >= Wh) continue;
      const float nz = noise2 != nullptr ? to_f(noise2[i * Wh + j]) : 0.f;
      const long long p = ((long long)n * Hh + i) * Wh + j;
#pragma unroll
      for (int ni = 0; ni < G::NI; ++ni) {
        const int go = o0 + n0 + ni * 8 + 2 * tq;
        if (go >= O) continue;
        const float v0 = act(acc[mi][ni][2 * h2] + nz);
        const float v1 = act(acc[mi][ni][2 * h2 + 1] + nz);
        if (feat != nullptr) store2(feat + p * O + go, v0, v1);
        if (rgb != nullptr) {
#pragma unroll
          for (int r = 0; r < CR; ++r)
            rp[mi][h2][r] =
                fmaf(v1, to_f(wrgb[(go + 1) * CR + r]),
                     fmaf(v0, to_f(wrgb[go * CR + r]), rp[mi][h2][r]));
        }
      }
    }
  if (rgb == nullptr) return;
  // sum a pixel row's four lanes, then its WN warps, in a fixed order; the
  // sums go through the ring, which the K loop has finished with
  float* const R = reinterpret_cast<float*>(smem);  // [TP][WN][CR]
  const int wn = threadIdx.x / 32 % G::WN;
#pragma unroll
  for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
      for (int r = 0; r < CR; ++r) {
        float v = rp[mi][h2][r];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (tq == 0)
          R[((m0 + mi * 16 + g + 8 * h2) * G::WN + wn) * CR + r] = v;
      }
  __syncthreads();
  for (int e = threadIdx.x; e < G::TP * CR; e += G::THREADS) {
    const int lp = e / CR, r = e % CR;
    const int i = h0 + lp / U::TW, j = w0 + lp % U::TW;
    if (i >= Hh || j >= Wh) continue;
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < G::WN; ++v) s += R[(lp * G::WN + v) * CR + r];
    const long long p = ((long long)n * Hh + i) * Wh + j;
    if (OT == 1)
      rgb[p * CR + r] = from_f<T>(s + to_f(brgb[r]));
    else
      part[((long long)ot * NP + p) * CR + r] = s;
  }
}

// rgb = b_rgb + the output tiles' partial sums, added in tile order.
template <typename T>
__global__ void rgb_sum_kernel(const float* __restrict__ part,
                               const T* __restrict__ brgb,
                               T* __restrict__ rgb, long long n3, int OT) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < n3; e += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int t = 0; t < OT; ++t) s += part[t * n3 + e];
    rgb[e] = from_f<T>(s + to_f(brgb[e % CR]));
  }
}

namespace {
template <typename T, typename G>
struct Launch {
  static int run(int blocks, int threads, int smem, const void* x,
                 const void* skip, const void* noise_up, const void* wdw,
                 const void* bdw, const void* wpw, const void* noise2,
                 const void* wrgb, const void* brgb, void* feat, void* rgb,
                 void* part, int N, int Hl, int Wl, int C, int O,
                 cudaStream_t stream) {
    using U = Up<T, G>;
    const int OT = (O + G::TO - 1) / G::TO;
    const long long tiles = (long long)N *
                            ((2 * Hl + U::TH - 1) / U::TH) *
                            ((2 * Wl + U::TW - 1) / U::TW);
    if (threads != G::THREADS || smem != U::SMEM || blocks != tiles * OT ||
        C % 8 != 0 || O % 8 != 0 || (feat == nullptr && rgb == nullptr) ||
        (rgb != nullptr && OT > 1 && part == nullptr))
      return (int)cudaErrorInvalidConfiguration;
    cudaError_t err = allow_smem(upblock_kernel<T, G>, smem);
    if (err != cudaSuccess) return (int)err;
    upblock_kernel<T, G><<<blocks, threads, smem, stream>>>(
        (const T*)x, (const T*)skip, (const T*)noise_up, (const T*)wdw,
        (const T*)bdw, (const T*)wpw, (const T*)noise2, (const T*)wrgb,
        (const T*)brgb, (T*)feat, (T*)rgb, (float*)part, N, Hl, Wl, C, O);
    err = cudaGetLastError();
    if (err != cudaSuccess || rgb == nullptr || OT == 1) return (int)err;
    const long long n3 = (long long)N * (2 * Hl) * (2 * Wl) * CR;
    const long long want = (n3 + 255) / 256;
    const int sum_blocks = want < 2048 ? (int)want : 2048;
    rgb_sum_kernel<T><<<sum_blocks, 256, 0, stream>>>(
        (const float*)part, (const T*)brgb, (T*)rgb, n3, OT);
    return (int)cudaGetLastError();
  }
};
}  // namespace

// dtype: 0 = float32, 1 = bfloat16; cfg, blocks, threads, smem: the launch
// plan of migan_tpu_torch/ops/kernels/plan.py, checked here. noise2 may be
// null; feat or rgb may be null (not both); wrgb/brgb are read only when
// rgb is not null; part, the f32 [O/TO, N*Hh*Wh, 3] scratch of the rgb
// partial sums, is needed when rgb is not null and O > TO. C and O are
// multiples of 8. Returns the CUDA error code of the launch (0 = success).
extern "C" int migan_upblock(int dtype, int cfg, int blocks, int threads,
                             int smem, const void* x, const void* skip,
                             const void* noise_up, const void* wdw,
                             const void* bdw, const void* wpw,
                             const void* noise2, const void* wrgb,
                             const void* brgb, void* feat, void* rgb,
                             void* part, int N, int Hl, int Wl, int C, int O,
                             void* stream) {
  return dispatch<Launch, UpCfg0, UpCfg1, UpCfg2>(
      dtype, cfg, blocks, threads, smem, x, skip, noise_up, wdw, bdw, wpw,
      noise2, wrgb, brgb, feat, rgb, part, N, Hl, Wl, C, O,
      (cudaStream_t)stream);
}
