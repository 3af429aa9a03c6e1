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
// and/or the 3-channel rgb are written. Each dw tap re-evaluates t from
// x_lo (four up-sample taps), so the kernel spends CUDA-core work to save
// device-memory passes. The design keeps t and the dw output out of device
// memory (phase 1 writes act(dw3x3(t) + b_dw) to shared memory; phase 2
// runs the pointwise product) and computes torgb in the
// epilogue: each thread accumulates feat . w_rgb over the output channels
// it owns, and a warp shuffle sums the 16 threads of a pixel row, in a
// fixed order.
//
// Edges follow the plain path: the up-sample sees x_lo = 0 outside its
// range (out[2k] = .75 x[k] + .25 x[k-1], out[2k+1] = .75 x[k] + .25
// x[k+1] per axis), and the dw conv sees t = 0 outside the image.
//
// Block shape: a thread block owns a tile of TP = 64 output pixels
// (consecutive in the flat N*H*W order of a contiguous NHWC tensor) and
// runs two phases.
//
//   phase 1  the stencil work above for all C channels of the tile,
//            written as f32 into shared memory A[TP][C + 1];
//   phase 2  the pointwise 1x1 as a [TP, C] x [C, O] product on CUDA-core
//            FMAs (`pointwise` below), in output tiles of TO = 64
//            channels; the weight rows are staged through shared memory
//            KC = 32 at a time, and each of the 256 threads keeps a 4 x 4
//            register tile of sums.
//
// A's row stride C + 1 is odd, so the phase-1 stores (consecutive
// channels) and the phase-2 loads (four pixel rows per thread) fall in
// distinct shared-memory banks. Shared memory grows with C (131 KB at
// C = 512), which is why C = 1024 does not fit a block.
#include "common.cuh"

using namespace migan;

namespace {

constexpr int TP = 64;        // output pixels per block
constexpr int TO = 64;        // output channels per phase-2 pass
constexpr int KC = 32;        // weight rows staged per step
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int CR = 3;         // rgb channels

// Shared memory a block asks for: A plus the staged weight rows.
inline size_t smem_bytes(int C) {
  return sizeof(float) * ((size_t)TP * (C + 1) + (size_t)KC * TO);
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

}  // namespace

template <typename T>
__global__ void __launch_bounds__(THREADS)
    upblock_kernel(const T* __restrict__ x, const T* __restrict__ skip,
                   const T* __restrict__ noise_up, const T* __restrict__ wdw,
                   const T* __restrict__ bdw, const T* __restrict__ wpw,
                   const T* __restrict__ noise2, const T* __restrict__ wrgb,
                   const T* __restrict__ brgb, T* __restrict__ feat,
                   T* __restrict__ rgb, int N, int Hl, int Wl, int C, int O) {
  extern __shared__ __align__(16) float smem[];
  float* A = smem;
  float* Bs = smem + TP * (C + 1);
  const int CS = C + 1;
  const int Hh = 2 * Hl, Wh = 2 * Wl;
  const long long NP = (long long)N * Hh * Wh;
  const long long HW = (long long)Hh * Wh;
  const long long p0 = (long long)blockIdx.x * TP;

  // phase 1: A[lp][c] = act(dw3x3(t) + b_dw)
  for (int e = threadIdx.x; e < TP * C; e += THREADS) {
    const int lp = e / C, c = e % C;
    const long long pix = p0 + lp;
    float v = 0.f;
    if (pix < NP) {
      const int w = (int)(pix % Wh);
      const long long tt = pix / Wh;
      const int h = (int)(tt % Hh);
      const long long n = tt / Hh;
      const T* xn = x + n * Hl * Wl * C + c;
      float s = 0.f;
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy) {
        const int hh = h + dy;
        if (hh < 0 || hh >= Hh) continue;
        // up-sample taps along h: rows k (0.75) and k2 (0.25)
        const int k = hh >> 1;
        const int k2 = (hh & 1) ? k + 1 : k - 1;
        const bool k2ok = k2 >= 0 && k2 < Hl;
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx) {
          const int ww = w + dx;
          if (ww < 0 || ww >= Wh) continue;
          const int m = ww >> 1;
          const int m2 = (ww & 1) ? m + 1 : m - 1;
          const bool m2ok = m2 >= 0 && m2 < Wl;
          float u = 0.5625f * to_f(xn[((long long)k * Wl + m) * C]);
          if (m2ok) u = fmaf(0.1875f, to_f(xn[((long long)k * Wl + m2) * C]), u);
          if (k2ok) {
            u = fmaf(0.1875f, to_f(xn[((long long)k2 * Wl + m) * C]), u);
            if (m2ok)
              u = fmaf(0.0625f, to_f(xn[((long long)k2 * Wl + m2) * C]), u);
          }
          const long long q = (long long)hh * Wh + ww;
          const float t = act(u + to_f(noise_up[q])) +
                          to_f(skip[(n * HW + q) * C + c]);
          s = fmaf(t, to_f(wdw[((dy + 1) * 3 + dx + 1) * C + c]), s);
        }
      }
      v = act(s + to_f(bdw[c]));
    }
    A[lp * CS + c] = v;
  }
  __syncthreads();

  // phase 2: pointwise product [+ noise2] -> act; feat store; torgb sums
  float part[4][CR];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int r = 0; r < CR; ++r) part[i][r] = 0.f;
  pointwise<T>(A, Bs, wpw, C, O, [&](int i, int lp, int o, float s) {
    const long long pix = p0 + lp;
    if (pix >= NP) return;
    if (noise2 != nullptr) s += to_f(noise2[pix % HW]);
    s = act(s);
    if (feat != nullptr) feat[pix * O + o] = from_f<T>(s);
    if (rgb != nullptr) {
#pragma unroll
      for (int r = 0; r < CR; ++r)
        part[i][r] = fmaf(s, to_f(wrgb[o * CR + r]), part[i][r]);
    }
  });
  if (rgb == nullptr) return;
  // the 16 threads tx = 0..15 of one pixel row are lanes 0-15 or 16-31
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int r = 0; r < CR; ++r) {
      float v = part[i][r];
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      part[i][r] = v;
    }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long pix = p0 + ty * 4 + i;
      if (pix >= NP) continue;
#pragma unroll
      for (int r = 0; r < CR; ++r)
        rgb[pix * CR + r] = from_f<T>(part[i][r] + to_f(brgb[r]));
    }
  }
}

template <typename T>
static int launch(const void* x, const void* skip, const void* noise_up,
                  const void* wdw, const void* bdw, const void* wpw,
                  const void* noise2, const void* wrgb, const void* brgb,
                  void* feat, void* rgb, int N, int Hl, int Wl, int C, int O,
                  cudaStream_t stream) {
  const size_t smem = smem_bytes(C);
  cudaError_t err = allow_smem(upblock_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long NP = (long long)N * (2 * Hl) * (2 * Wl);
  const unsigned grid = (unsigned)((NP + TP - 1) / TP);
  upblock_kernel<T><<<grid, THREADS, smem, stream>>>(
      (const T*)x, (const T*)skip, (const T*)noise_up, (const T*)wdw,
      (const T*)bdw, (const T*)wpw, (const T*)noise2, (const T*)wrgb,
      (const T*)brgb, (T*)feat, (T*)rgb, N, Hl, Wl, C, O);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16. noise2 may be null; feat or rgb may be
// null (not both); wrgb/brgb are read only when rgb is not null. Returns
// the CUDA error code of the launch (0 = success).
extern "C" int migan_upblock(int dtype, const void* x, const void* skip,
                             const void* noise_up, const void* wdw,
                             const void* bdw, const void* wpw,
                             const void* noise2, const void* wrgb,
                             const void* brgb, void* feat, void* rgb, int N,
                             int Hl, int Wl, int C, int O, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(x, skip, noise_up, wdw, bdw, wpw, noise2, wrgb, brgb,
                         feat, rgb, N, Hl, Wl, C, O, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, skip, noise_up, wdw, bdw, wpw, noise2,
                                 wrgb, brgb, feat, rgb, N, Hl, Wl, C, O, st);
  return (int)cudaErrorInvalidValue;
}
