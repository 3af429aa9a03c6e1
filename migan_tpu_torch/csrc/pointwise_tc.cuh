// The tensor-core pointwise product shared by sepconv.cu, downblock.cu and
// upblock.cu.
//
// A thread block owns TP output pixels and TO output channels. It streams
// the input channels through shared memory in K chunks of KC = 32:
//
//   A stage  [TP][KC]  the kernel's own phase 1 (stencil, activation)
//                      for one channel chunk, written by the block's
//                      threads in the storage type: bfloat16 is rounded
//                      there, as the TPU kernels round the pointwise
//                      input to the weight dtype; float32 stays float32;
//   B stage  [KC][TO]  the weight rows of the chunk, copied from the
//                      [C, O] weights by cp.async (16 bytes a thread,
//                      zero-filled past C and O);
//   x stage            the kernel's stencil input for the chunk (its
//                      tile's pixels and halo, KC channels), also copied
//                      by cp.async, so that phase 1 reads only shared
//                      memory.
//
// All three are double-buffered (k_loop): while chunk i's product runs
// and chunk i + 1's phase 1 fills its A stage, chunk i + 1's weights and
// chunk i + 2's x are in flight; one wait and one __syncthreads per
// chunk. Shared memory does not grow with C. Staging x matters: reading
// it through L1 tap by tap instead, with the loads waited on inside phase
// 1, made these kernels 3-5x slower (NVIDIA H100 80GB HBM3, 700 W;
// PERF.md).
//
// The product runs on tensor cores with mma.sync, warp tiles of
// (16 MI) x (8 NI):
//   bfloat16  m16n8k16 bf16 x bf16 -> f32; A fragments are 32-bit shared
//             loads, B fragments ldmatrix.trans from the [KC][TO] stage;
//   float32   three m16n8k8 TF32 products per step on a hi/lo split of
//             both operands: lo.hi + hi.lo on the tensor cores into a
//             second sum, and hi.hi, the large term, of each k step into a
//             zeroed fragment that is added to the float32 sum on the CUDA
//             cores, which round to nearest where the tensor core's own
//             accumulation truncates. Accumulating hi.hi on the tensor
//             cores across K made the kernels 5-10x further from float64
//             than the plain float32 version; a three-way split did not
//             change that, moving the sum did (PERF.md). The splits are
//             made in registers as the fragments are read, so neither
//             operand is stored twice.
// Row strides are padded (A: KC + 4 floats or KC + 8 bf16; B: TO + 8) so
// that the fragment loads of a warp fall in distinct banks.
//
// The block configurations below are mirrored, with the launch geometry
// and shared-memory sizes, by migan_tpu_torch/ops/kernels/plan.py, which
// picks one per call; the C entry points check what they are given.
#pragma once

#include "common.cuh"

namespace migan {
namespace tc {

constexpr int KC = 32;  // input channels per K chunk

// TP pixels x TO channels per block; WM x WN warps, each (TP/WM) x (TO/WN);
// TH: downblock's and upblock's tile rows (their tile is TH x TP/TH
// pixels, lo-res for downblock, hi-res for upblock).
template <int TP_, int TO_, int WM_, int WN_, int TH_>
struct Cfg {
  static constexpr int TP = TP_, TO = TO_, WM = WM_, WN = WN_, TH = TH_;
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int MIN_BLOCKS = 512 / THREADS;  // caps registers at 128
  static constexpr int MI = TP / WM / 16;  // m16 fragments per warp
  static constexpr int NI = TO / WN / 8;   // n8 fragments per warp
  static_assert(MI >= 1 && NI >= 1 && MI * WM * 16 == TP &&
                    NI * WN * 8 == TO && THREADS % KC == 0,
                "bad block configuration");
};
// sepconv: large shapes with O a multiple of 128, of 64; small shapes,
// where only small tiles give enough blocks for 132 SMs.
using SepCfg0 = Cfg<64, 128, 2, 4, 8>;
using SepCfg1 = Cfg<64, 64, 4, 2, 8>;
using SepCfg2 = Cfg<16, 32, 1, 4, 4>;
// downblock: the same tiles with 16 warps for the larger ones, as its
// shared memory (the x window and y) allows one large block per SM.
using DownCfg0 = Cfg<64, 128, 4, 4, 8>;
using DownCfg1 = Cfg<64, 64, 4, 4, 8>;
using DownCfg2 = SepCfg2;
// upblock: sepconv's large tiles (8 x 8 hi-res pixels, two blocks per SM);
// the small one 4 x 4 pixels and 64 channels, which gives a full wave at
// the lowest level at batch 1 with half the recomputed phase 1 of TO = 32.
using UpCfg0 = SepCfg0;
using UpCfg1 = SepCfg1;
using UpCfg2 = Cfg<16, 64, 1, 4, 4>;

// The two-stage ring at the start of dynamic shared memory: B0 B1 A0 A1.
template <typename T, typename G>
struct Ring {
  static constexpr int KS = sizeof(T) == 4 ? KC + 4 : KC + 8;  // A row
  static constexpr int TOS = G::TO + 8;                          // B row
  static constexpr int A_BYTES = sizeof(T) * G::TP * KS;
  static constexpr int B_BYTES = sizeof(T) * KC * TOS;
  static constexpr int BYTES = 2 * (A_BYTES + B_BYTES);
};

template <typename G>
using Acc = float[G::MI][G::NI][4];

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// One 16-byte cp.async into shared memory; zero-fills when !ok (src is
// then not read, but must be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Weight rows k0 .. k0 + KC - 1, columns o0 .. o0 + TO - 1 of W [C, O]
// into the B stage. O is a multiple of 8, so a 16-byte vector lies wholly
// inside or wholly outside [0, O).
template <typename T, typename G>
__device__ __forceinline__ void load_b_async(T* Bs, const T* __restrict__ W,
                                             int C, int O, int k0, int o0) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = G::TO / VEC;
  for (int e = threadIdx.x; e < KC * PER_ROW; e += G::THREADS) {
    const int k = e / PER_ROW, o = (e % PER_ROW) * VEC;
    const int gk = k0 + k, go = o0 + o;
    const bool ok = gk < C && go < O;
    cp_async16(Bs + k * Ring<T, G>::TOS + o,
               ok ? W + (long long)gk * O + go : W, ok);
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// v = hi + lo, both TF32 (round to nearest, ties away: cvt.rna).
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(v));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(v - __uint_as_float(hi)));
}

// This warp's first pixel row and output column in the block tile.
template <typename G>
__device__ __forceinline__ int warp_m0() {
  return (threadIdx.x / 32 / G::WN) * (G::TP / G::WM);
}
template <typename G>
__device__ __forceinline__ int warp_n0() {
  return (threadIdx.x / 32 % G::WN) * (G::TO / G::WN);
}

// acc += A stage x B stage, bfloat16 operands.
template <typename G>
__device__ __forceinline__ void mma_chunk(Acc<G>& acc,
                                          const __nv_bfloat16* As,
                                          const __nv_bfloat16* Bs) {
  using R = Ring<__nv_bfloat16, G>;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int m0 = warp_m0<G>(), n0 = warp_n0<G>();
#pragma unroll
  for (int kk = 0; kk < KC; kk += 16) {
    uint32_t b[G::NI][2];
#pragma unroll
    for (int ni = 0; ni < G::NI; ++ni) {
      // lanes 0-7 address rows kk..kk+7, lanes 8-15 rows kk+8..kk+15
      const __nv_bfloat16* p = Bs + (kk + lane % 16) * R::TOS + n0 + ni * 8;
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
          : "=r"(b[ni][0]), "=r"(b[ni][1])
          : "r"(smem_u32(p)));
    }
#pragma unroll
    for (int mi = 0; mi < G::MI; ++mi) {
      const __nv_bfloat16* p = As + (m0 + mi * 16 + g) * R::KS + kk + 2 * t;
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(p);
      a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * R::KS);
      a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
      a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * R::KS + 8);
#pragma unroll
      for (int ni = 0; ni < G::NI; ++ni)
        mma_bf16(acc[mi][ni], a, b[ni][0], b[ni][1]);
    }
  }
}

// acc += A stage x B stage, float32 operands as three TF32 products:
// a_lo b_hi + a_hi b_lo into `small` on the tensor cores, and a_hi b_hi of
// each k step into a zeroed fragment added to acc on the CUDA cores.
template <typename G>
__device__ __forceinline__ void mma_chunk(Acc<G>& acc, Acc<G>& small,
                                          const float* As,
                                          const float* Bs) {
  using R = Ring<float, G>;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int m0 = warp_m0<G>(), n0 = warp_n0<G>();
#pragma unroll
  for (int kk = 0; kk < KC; kk += 8) {
    uint32_t bh[G::NI][2], bl[G::NI][2];
#pragma unroll
    for (int ni = 0; ni < G::NI; ++ni) {
      const float* p = Bs + (kk + t) * R::TOS + n0 + ni * 8 + g;
      split_tf32(p[0], bh[ni][0], bl[ni][0]);
      split_tf32(p[4 * R::TOS], bh[ni][1], bl[ni][1]);
    }
#pragma unroll
    for (int mi = 0; mi < G::MI; ++mi) {
      const float* p = As + (m0 + mi * 16 + g) * R::KS + kk + t;
      uint32_t ah[4], al[4];
      split_tf32(p[0], ah[0], al[0]);
      split_tf32(p[8 * R::KS], ah[1], al[1]);
      split_tf32(p[4], ah[2], al[2]);
      split_tf32(p[8 * R::KS + 4], ah[3], al[3]);
#pragma unroll
      for (int ni = 0; ni < G::NI; ++ni) {
        mma_tf32(small[mi][ni], al, bh[ni][0], bh[ni][1]);
        mma_tf32(small[mi][ni], ah, bl[ni][0], bl[ni][1]);
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        mma_tf32(d, ah, bh[ni][0], bh[ni][1]);
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mi][ni][r] += d[r];
      }
    }
  }
}

// acc += A stage x B stage for bfloat16 operands; `small` is not used.
template <typename G>
__device__ __forceinline__ void mma_chunk(Acc<G>& acc, Acc<G>&,
                                          const __nv_bfloat16* As,
                                          const __nv_bfloat16* Bs) {
  mma_chunk<G>(acc, As, Bs);
}

// The K loop. The kernel keeps two stages of its stencil input (x) after
// the ring, and gives two callbacks:
//   xload(k, s)            issue the cp.async copies of chunk k's input
//                          into x stage s (no commit);
//   phase1(k, s, As, mid)  fill the A stage As with chunk k's channels
//                          (zeros past C) from x stage s, and call mid()
//                          once, where the previous chunk's product should
//                          overlap its work. Every thread of the block
//                          calls it, so it may hold __syncthreads.
// Chunk k + 1's weights and chunk k + 2's input are in flight while chunk
// k + 1's phase 1 and chunk k's product run; one wait and one barrier per
// chunk.
template <typename T, typename G, typename XLoad, typename Phase1>
__device__ __forceinline__ void k_loop(Acc<G>& acc, unsigned char* smem,
                                       const T* __restrict__ W, int C, int O,
                                       int o0, XLoad& xload, Phase1& phase1) {
  using R = Ring<T, G>;
  Acc<G> small;  // float32: the small terms' sum
#pragma unroll
  for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < G::NI; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = small[mi][ni][r] = 0.f;
  T* const B0 = reinterpret_cast<T*>(smem);
  T* const A0 = reinterpret_cast<T*>(smem + 2 * R::B_BYTES);
  constexpr int BE = R::B_BYTES / sizeof(T), AE = R::A_BYTES / sizeof(T);
  const int nk = (C + KC - 1) / KC;
  load_b_async<T, G>(B0, W, C, O, 0, o0);
  xload(0, 0);
  if (nk > 1) xload(1, 1);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  phase1(0, 0, A0, [] {});
  __syncthreads();
  for (int i = 0; i < nk; ++i) {
    const int s = i & 1;
    const T* Bs = B0 + s * BE;
    const T* As = A0 + s * AE;
    if (i + 1 < nk) load_b_async<T, G>(B0 + (s ^ 1) * BE, W, C, O,
                                       (i + 1) * KC, o0);
    if (i + 2 < nk) xload(i + 2, s);
    cp_async_commit();
    if (i + 1 < nk) {
      phase1(i + 1, s ^ 1, A0 + (s ^ 1) * AE,
             [&] { mma_chunk<G>(acc, small, As, Bs); });
    } else {
      mma_chunk<G>(acc, small, As, Bs);
    }
    cp_async_wait_all();
    __syncthreads();
  }
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < G::NI; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mi][ni][r] += small[mi][ni][r];
  }
}

// epi(pixel row, even channel column, v, v') for each pair of sums a
// thread holds: (row, col) and (row, col + 1) of the block tile.
template <typename G, typename Epi>
__device__ __forceinline__ void for_each_pair(const Acc<G>& acc, Epi epi) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int m0 = warp_m0<G>(), n0 = warp_n0<G>();
#pragma unroll
  for (int mi = 0; mi < G::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < G::NI; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        epi(m0 + mi * 16 + g + 8 * h, n0 + ni * 8 + 2 * t,
            acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// L<T, G>::run(args...) for storage code dtype (0 float32, 1 bfloat16)
// and the kernel's block configuration cfg (0, 1, 2: G0, G1, G2).
template <template <typename, typename> class L, typename G0, typename G1,
          typename G2, typename... Args>
inline int dispatch(int dtype, int cfg, Args... args) {
  using BF = __nv_bfloat16;
  if (dtype == 0) {
    if (cfg == 0) return L<float, G0>::run(args...);
    if (cfg == 1) return L<float, G1>::run(args...);
    if (cfg == 2) return L<float, G2>::run(args...);
  } else if (dtype == 1) {
    if (cfg == 0) return L<BF, G0>::run(args...);
    if (cfg == 1) return L<BF, G1>::run(args...);
    if (cfg == 2) return L<BF, G2>::run(args...);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc
}  // namespace migan
