// Fused up-sampling synthesis block for Hopper (sm_90a):
//
//     t    = act( up2_[1,3,3,1](x_lo) + noise_up ) + skip       at [Hh, Wh]
//     feat = act( pw1x1( act( dw3x3(t) + b_dw ) ) [+ noise2] )
//     rgb  = feat . w_rgb + b_rgb [+ up2_[1,3,3,1](img_lo)]     (optional)
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
//
// The rgb pyramid (optional img_lo [N, Hl, Wl, 3], with rgb): the image of
// the level below, up-sampled by the same [1,3,3,1] FIR as x_lo, is added
// to rgb in f32 before its one store, in the block itself with one output
// tile and in rgb_sum_kernel with more. Each rgb value reads 1-4 of
// img_lo's values (up2_rgb), so the generator's pyramid costs one
// 3-channel read instead of a pass of its own.
//
// Phase input (PHASE, a template argument, so the main path's kernel is
// compiled as before): x is [N, Hl, Wl, 4C], the four up-sampling phases
// of ops/conv.py:pw_up2_phase, which folds the FIR into the preceding
// pointwise conv. Each chunk stages the four phase groups' channels
// g * C + k * KC .. over the same x_lo window (4x its bytes), and step 1
// becomes a select with no taps: t(h, w) = act(x4[h >> 1, w >> 1,
// ((h & 1) * 2 + (w & 1)) * C + c] + noise_up) + skip, 0 outside the
// image as above.
#include "pointwise_tc.cuh"

using namespace migan;
using namespace migan::tc;

namespace {

constexpr int CR = 3;  // rgb channels

// Shared memory past the ring: two stages of the x_lo (four phase
// groups of it with PHASE) and skip windows, t over its window (f32), and
// noise_up over the same window.
template <typename T, typename G, bool PHASE>
struct Up {
  static constexpr int TH = G::TH, TW = G::TP / G::TH;
  static constexpr int XH = TH / 2 + 2, XW = TW / 2 + 2;  // x_lo window
  static constexpr int SH = TH + 2, SW = TW + 2;          // t, skip window
  static constexpr int XG = PHASE ? 4 : 1;  // x_lo values per pixel, chunk
  static constexpr int XPIX = XH * XW, SPIX = SH * SW;
  static constexpr int STAGE_BYTES = sizeof(T) * (XG * XPIX + SPIX) * KC;
  static constexpr int T_BYTES = sizeof(float) * SPIX * KC;
  static constexpr int NZ_BYTES = sizeof(float) * SPIX;
  static constexpr int SMEM =
      Ring<T, G>::BYTES + 2 * STAGE_BYTES + T_BYTES + NZ_BYTES;
  static_assert(TH % 2 == 0 && TW % 2 == 0 && TH * TW == G::TP,
                "tiles start on even hi-res rows and columns");
  static_assert(sizeof(float) * G::TP * G::WN * CR <= Ring<T, G>::BYTES,
                "the rgb sums reuse the ring");
};

// img_lo (batch n, [Hl, Wl, 3]) up-sampled by the [1,3,3,1] FIR at hi-res
// pixel (i, j), channel r: the x_lo stencil of phase 1 (along w, then
// along h; x_lo = 0 outside its range), for one pixel from global memory
template <typename T>
__device__ __forceinline__ float up2_rgb(const T* __restrict__ img, int n,
                                         int Hl, int Wl, int i, int j,
                                         int r) {
  const int ki = i >> 1, kj = j >> 1;                // always in range
  const int ni = i & 1 ? ki + 1 : ki - 1;            // the .25 neighbours
  const int nj = j & 1 ? kj + 1 : kj - 1;
  const bool hi = ni >= 0 && ni < Hl, wi = nj >= 0 && nj < Wl;
  const T* const b = img + (long long)n * Hl * Wl * CR + r;
  auto at = [&](int h, int w) {
    return to_f(b[((long long)h * Wl + w) * CR]);
  };
  const float row = fmaf(0.75f, at(ki, kj), 0.25f * (wi ? at(ki, nj) : 0.f));
  const float nrow =
      hi ? fmaf(0.75f, at(ni, kj), 0.25f * (wi ? at(ni, nj) : 0.f)) : 0.f;
  return fmaf(0.75f, row, 0.25f * nrow);
}

}  // namespace

template <typename T, typename G, bool PHASE>
__global__ void __launch_bounds__(G::THREADS, G::MIN_BLOCKS)
    upblock_kernel(const T* __restrict__ x, const T* __restrict__ skip,
                   const T* __restrict__ noise_up, const T* __restrict__ wdw,
                   const T* __restrict__ bdw, const T* __restrict__ wpw,
                   const T* __restrict__ noise2, const T* __restrict__ wrgb,
                   const T* __restrict__ brgb, const T* __restrict__ img,
                   T* __restrict__ feat, T* __restrict__ rgb,
                   float* __restrict__ part, int N, int Hl, int Wl, int C,
                   int O) {
  using U = Up<T, G, PHASE>;
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
  const int XC = U::XG * C;  // x_lo's channels
  const T* const xn = x + (long long)n * Hl * Wl * XC;
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
  // (h0/2 - 1 + r, w0/2 - 1 + q) (with PHASE its four groups g at
  // (r, q) * 4 + g), then skip window (r, q) is hi-res (h0 - 1 + r,
  // w0 - 1 + q); zeros outside the image and past C (C is a multiple of
  // 8, so a vector lies wholly inside or outside)
  auto xload = [&](int k, int s) {
    T* const Xs = S0 + s * SE;
    constexpr int VPP = KC / VEC;
    constexpr int XM = U::XG * U::XPIX;
    for (int e = threadIdx.x; e < (XM + U::SPIX) * VPP; e += G::THREADS) {
      const int m = e / VPP, gc = k * KC + (e % VPP) * VEC;
      const T* src = x;
      bool ok = false;
      if (m < XM) {
        const int mx = m / U::XG, g = m % U::XG;
        const int h = h0 / 2 - 1 + mx / U::XW, w = w0 / 2 - 1 + mx % U::XW;
        ok = h >= 0 && h < Hl && w >= 0 && w < Wl && gc < C;
        if (ok) src = xn + ((long long)h * Wl + w) * XC + g * C + gc;
      } else {
        const int ms = m - XM;
        const int h = h0 - 1 + ms / U::SW, w = w0 - 1 + ms % U::SW;
        ok = h >= 0 && h < Hh && w >= 0 && w < Wh && gc < C;
        if (ok) src = sn + ((long long)h * Wh + w) * C + gc;
      }
      cp_async16(Xs + m * KC + (e % VPP) * VEC, src, ok);
    }
  };

  auto phase1 = [&](int k, int s, T* As, auto&& mid) {
    const T* const Xs = S0 + s * SE;
    const T* const Ss = Xs + U::XG * U::XPIX * KC;
    const int gc = k * KC + c;
    const bool cok = gc < C;
    if constexpr (PHASE) {
      // step 1: t over the window, each pixel from its phase group: window
      // row r is hi-res row h0 - 1 + r, lo-res window row (r + 1) >> 1,
      // phase (r + 1) & 1 (h0 is even); the same along w
      for (int m = q0; m < U::SPIX; m += PSTEP) {
        const int r = m / U::SW, q = m % U::SW;
        const int h = h0 - 1 + r, w = w0 - 1 + q;
        const int xm = (((r + 1) >> 1) * U::XW + ((q + 1) >> 1)) * 4 +
                       ((r + 1) & 1) * 2 + ((q + 1) & 1);
        Tw[m * KC + c] = h >= 0 && h < Hh && w >= 0 && w < Wh
                             ? act(to_f(Xs[xm * KC + c]) + Nz[m]) +
                                   to_f(Ss[m * KC + c])
                             : 0.f;
      }
    } else {
      // step 1: t over the window in 2 x 2 units. Unit (i, j) is window
      // rows 2i, 2i + 1 and columns 2j, 2j + 1, from x_lo window rows i,
      // i + 1 and columns j, j + 1: window row 2i is hi-res row h0 - 1 +
      // 2i (odd), so .75 x[i] + .25 x[i + 1]; row 2i + 1 (even) .75
      // x[i + 1] + .25 x[i]; the same along w.
      constexpr int UW = U::TW / 2 + 1;
      for (int u = q0; u < (U::TH / 2 + 1) * UW; u += PSTEP) {
        const int i = u / UW, j = u % UW;
        float lw[2], rw[2];  // along w: columns 2j, 2j + 1; x rows i, i + 1
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
      rgb[p * CR + r] = from_f<T>(
          s + to_f(brgb[r]) +
          (img != nullptr ? up2_rgb(img, n, Hl, Wl, i, j, r) : 0.f));
    else
      part[((long long)ot * NP + p) * CR + r] = s;
  }
}

// rgb = b_rgb + the output tiles' partial sums, added in tile order
// [+ img_lo up-sampled].
template <typename T>
__global__ void rgb_sum_kernel(const float* __restrict__ part,
                               const T* __restrict__ brgb,
                               const T* __restrict__ img,
                               T* __restrict__ rgb, long long n3, int OT,
                               int Hl, int Wl) {
  const int Wh = 2 * Wl;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < n3; e += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int t = 0; t < OT; ++t) s += part[t * n3 + e];
    const int r = (int)(e % CR);
    s += to_f(brgb[r]);
    if (img != nullptr) {
      const long long p = e / CR;
      const int j = (int)(p % Wh);
      const long long q = p / Wh;
      s += up2_rgb(img, (int)(q / (2 * Hl)), Hl, Wl, (int)(q % (2 * Hl)), j,
                   r);
    }
    rgb[e] = from_f<T>(s);
  }
}

namespace {
template <bool PHASE>
struct Launch {
  template <typename T, typename G>
  struct L {
    static int run(int blocks, int threads, int smem, const void* x,
                   const void* skip, const void* noise_up, const void* wdw,
                   const void* bdw, const void* wpw, const void* noise2,
                   const void* wrgb, const void* brgb, const void* img,
                   void* feat, void* rgb, void* part, int N, int Hl, int Wl,
                   int C, int O, cudaStream_t stream) {
      using U = Up<T, G, PHASE>;
      const int OT = (O + G::TO - 1) / G::TO;
      const long long tiles = (long long)N *
                              ((2 * Hl + U::TH - 1) / U::TH) *
                              ((2 * Wl + U::TW - 1) / U::TW);
      if (threads != G::THREADS || smem != U::SMEM || blocks != tiles * OT ||
          C % 8 != 0 || O % 8 != 0 || (feat == nullptr && rgb == nullptr) ||
          (rgb != nullptr && OT > 1 && part == nullptr) ||
          (img != nullptr && rgb == nullptr))
        return (int)cudaErrorInvalidConfiguration;
      cudaError_t err = allow_smem(upblock_kernel<T, G, PHASE>, smem);
      if (err != cudaSuccess) return (int)err;
      upblock_kernel<T, G, PHASE><<<blocks, threads, smem, stream>>>(
          (const T*)x, (const T*)skip, (const T*)noise_up, (const T*)wdw,
          (const T*)bdw, (const T*)wpw, (const T*)noise2, (const T*)wrgb,
          (const T*)brgb, (const T*)img, (T*)feat, (T*)rgb, (float*)part, N,
          Hl, Wl, C, O);
      err = cudaGetLastError();
      if (err != cudaSuccess || rgb == nullptr || OT == 1) return (int)err;
      const long long n3 = (long long)N * (2 * Hl) * (2 * Wl) * CR;
      const long long want = (n3 + 255) / 256;
      const int sum_blocks = want < 2048 ? (int)want : 2048;
      rgb_sum_kernel<T><<<sum_blocks, 256, 0, stream>>>(
          (const float*)part, (const T*)brgb, (const T*)img, (T*)rgb, n3,
          OT, Hl, Wl);
      return (int)cudaGetLastError();
    }
  };
};
}  // namespace

// dtype: 0 = float32, 1 = bfloat16; cfg, blocks, threads, smem: the launch
// plan of migan_tpu_torch/ops/kernels/plan.py, checked here; mode: 0 x is
// x_lo [N, Hl, Wl, C], 1 the phase input [N, Hl, Wl, 4C]. noise2 may be
// null; feat or rgb may be null (not both); wrgb/brgb are read only when
// rgb is not null; img, the image of the level below [N, Hl, Wl, 3] whose
// up-sample is added to rgb, may be null and needs rgb; part, the f32
// [O/TO, N*Hh*Wh, 3] scratch of the rgb partial sums, is needed when rgb
// is not null and O > TO. C and O are multiples of 8. Returns the CUDA
// error code of the launch (0 = success).
extern "C" int migan_upblock(int dtype, int cfg, int blocks, int threads,
                             int smem, int mode, const void* x,
                             const void* skip,
                             const void* noise_up, const void* wdw,
                             const void* bdw, const void* wpw,
                             const void* noise2, const void* wrgb,
                             const void* brgb, const void* img, void* feat,
                             void* rgb, void* part, int N, int Hl, int Wl,
                             int C, int O, void* stream) {
#define MIGAN_UP(P)                                                       \
  dispatch<Launch<P>::L, UpCfg0, UpCfg1, UpCfg2>(                         \
      dtype, cfg, blocks, threads, smem, x, skip, noise_up, wdw, bdw, wpw, \
      noise2, wrgb, brgb, img, feat, rgb, part, N, Hl, Wl, C, O,          \
      (cudaStream_t)stream)
  if (mode == 0) return MIGAN_UP(false);
  if (mode == 1) return MIGAN_UP(true);
#undef MIGAN_UP
  return (int)cudaErrorInvalidValue;
}
