// Tensor-core products of the GRU backward (gru_bwd.cu) and of the
// forward kernels (gru_fwd.cu): out = A B as 3xTF32, on one of two kernels.
//
// Precision. Each float32 operand value v is split into hi = tf32(v) and
// lo = tf32(v - hi); the product is lo_a hi_b + hi_a lo_b + hi_a hi_b with
// float32 accumulation (the lo_a lo_b term, ~2^-22 of |ab|, is dropped).
// That keeps float32-class products (relative error ~1e-7 of the largest
// output on a long reduction, below float32 accumulation's own) where one
// TF32 or bf16 pass errs ~3e-4 or ~3e-3. A bf16 A operand (the frames, bf16
// x) is exact in TF32: its lo is 0, lo_a hi_b is skipped, and its products
// run as two TF32 passes (495/2 TFLOP/s float32-equivalent, against 495/3
// for a float32 A). bf16x3 was the faster candidate (989/3 TFLOP/s
// equivalent) but errs ~5e-6 of the largest output per product, too close
// to the 1e-5 that the card tests hold the gradients to. The tensor cores
// round their sums toward zero, so each 32-deep stage is summed apart from
// 0 and added to the accumulator by float32 adds that round to nearest, on
// both kernels.
//
// Two kernels. TF32 wgmma reads B only K-major from shared memory, in its
// core-matrix layout, and takes A from registers (split there).
//   - wgmma_gemm_kernel takes the products whose B is a weight: x Wi (the
//     forward's projection), the backward's gate recompute over [x | h]
//     (Wi and Wh) and dx = dgi Wi^T. A weight is constant over the call and
//     small (2.8 MB at fig_5 width's layer 0), so one pass a call
//     (presplit_kernel) writes its hi and lo planes in that layout (an
//     image, see WImage), and a stage's B is one contiguous bulk copy.
//     Tiles of 128 x 128: one producer warpgroup stages A by cp.async and B
//     by cp.async.bulk into a 3-stage ring under mbarriers; two consumer
//     warpgroups of 64 rows each split their A fragments in registers and
//     issue m64n128k8 wgmmas.
//   - mma_gemm_kernel (mma.sync.m16n8k8, fragments from registers) takes
//     the rest: the weight gradients read both operands M- or N-major
//     (x^T G), which wgmma does not take for TF32. It also takes the
//     weight products of calls too small for the image's pass to pay (a
//     stream's B = 1 step): the route is by row count alone
//     (GRU_WGMMA_MIN_ROWS). Both sum in the same order (k8 products, a
//     stage's part, float32 adds) and gave the same bits at every shape
//     measured on the H100. The sweeps' step kernels (gru_fwd.cu,
//     gru_bwd.cu) are small grids a step and run mma_stage on their own
//     tiles.
//
// mma_gemm_kernel's tiles. A CTA owns a BM x BN block of out, its warps
// WM x WN each (MI x NI m16n8 tiles). A stage holds a BK-deep slice of
// both operands as they lie in device memory (rows of the operand's
// contiguous axis), copied with 16-byte cp.async where every run is
// 16-byte aligned and with one element a copy otherwise; the ragged edges
// are zero filled by the copies' source size, never by padding the
// caller's tensors. Pitches (in elements) keep the fragment reads free of
// bank conflicts: a [row][k] tile read at (g, t) wants pitch = 4 mod 32
// (float) or 8 mod 64 (bf16, 2 per bank), a [k][row] tile read at (t, g)
// wants 8 mod 32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

template <int BM_, int BN_, int WARPS_M_, int WARPS_N_, int STAGES_,
          int MIN_BLOCKS_>
struct MmaCfg {
  static constexpr int BM = BM_, BN = BN_, BK = 32, STAGES = STAGES_;
  static constexpr int WARPS_N = WARPS_N_, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int WM = BM / WARPS_M_, WN = BN / WARPS_N_;
  static constexpr int NT = 32 * WARPS_M_ * WARPS_N_;
  static constexpr int MI = WM / 16, NI = WN / 8;
};

// MmaCfg<BM, BN, warps along M, warps along N, stages, CTAs per SM>.
// The defaults below can be overridden at build time (-DGRU_MMA_BIG=...,
// -DGRU_MMA_SMALL=...): `python tools/port_probes.py bwd` builds such
// variants and times them beside the defaults. The large products (gates, dx, dW): 8 warps of 64 x 32, 3
// stages.
#ifndef GRU_MMA_BIG
#define GRU_MMA_BIG 128, 128, 2, 4, 3, 1
#endif
// the backward sweep's step tile (gru_bwd.cu: dh' = dgh Wh^T, B x H,
// split over K across a cluster): 4 warps of 32 x 32, three CTAs on an
// SM, so that a step of B = 1000-2000 rows and H = 500 columns fills the
// card
#ifndef GRU_MMA_SMALL
#define GRU_MMA_SMALL 64, 64, 2, 2, 3, 3
#endif
using MmaBig = MmaCfg<GRU_MMA_BIG>;
using MmaSmall = MmaCfg<GRU_MMA_SMALL>;

// One reduction segment. A row n (a data row: (t, b) for x, b for a step's
// g) starts at a + (n / a_b) * a_st + (n % a_b) * a_sb elements, or at
// a + n * a_sb when a_b = 0. B is row-major with leading dimension ldb.
struct MmaSeg {
  const void* a;
  long long a_st, a_sb;
  int a_b;
  int a_vec;  // every A run 16-byte aligned
  const float* b;
  long long ldb;
  int b_vec;  // every B run 16-byte aligned
  int K;      // reduction length; 0 = no segment
};

// out[m, out_col + n] = sum over segments of A B + bias0[n] + bias1[n],
// m < M, n < N, into out + z * out_z, z = blockIdx.z.
//   A [m][k] (MK): element (m, k) is A row m, column k of the segment;
//     segment 0 is of type TA, segment 1 float. With kt_per > 0, z sums
//     only reduction tiles [z kt_per, (z+1) kt_per) of the segments.
//   A [k][m] (KM, the weight gradient): element (m, k) is column m < M of
//     data row k; z sums data rows [z k_per, (z+1) k_per) of k_total. Row
//     M of out receives sum_k B(k, n), the bias gradient (A's ones
//     column).
//   B [n][k] (NK): element (k, n) = b[n * ldb + k].
//   B [k][n] (KN): element (k, n) = b[k * ldb + col(n)], col(n) = n below
//     gap_at, n + gap from it on.
struct MmaArgs {
  MmaSeg seg[2];
  const float* bias0;
  const float* bias1;
  float* out;
  long long ldo, out_z;
  int out_col;
  long long M;
  int N;
  int kt_per;
  long long k_total, k_per;
  int gap_at, gap;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy of which the first `bytes` come from src, the rest are 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t tf32_bits(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_bits(v);
  lo = tf32_bits(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T>
__host__ __device__ constexpr bool is_bf16() {
  return std::is_same<T, __nv_bfloat16>::value;
}

__device__ __forceinline__ float smem_f32(const float* s, int i) {
  return s[i];
}
__device__ __forceinline__ float smem_f32(const __nv_bfloat16* s, int i) {
  return __uint_as_float(
      static_cast<uint32_t>(reinterpret_cast<const uint16_t*>(s)[i]) << 16);
}

// Shared-memory pitches (elements) of the operand tiles. A thread's two
// k slots of an m16n8k8 fragment (t and t + 4) are taken from the adjacent
// columns 2t and 2t + 1 of the tile, in A and B alike (a dot product does
// not care in which order its k run), so a [row][k] tile gives both in one
// 8-byte read (float; 4 bytes for bf16) and a [k][row] tile in two reads
// of adjacent rows. Conflict-free pitches: [row][k] 8 mod 32 floats (8
// mod 16 bf16), [k][row] 4 mod 32 floats (8 mod 64 bf16).
template <class C, typename T, bool KM>
__host__ __device__ constexpr int a_pitch() {
  return KM ? (is_bf16<T>() ? C::BM + 8 : C::BM + 4) : C::BK + 8;
}
template <class C, bool KN>
__host__ __device__ constexpr int b_pitch() {
  return KN ? C::BN + 4 : C::BK + 8;
}
template <class C, bool KM>
__host__ __device__ constexpr int a_bytes() {
  return KM ? C::BK * a_pitch<C, float, true>() * 4
            : C::BM * a_pitch<C, float, false>() * 4;
}
template <class C, bool KN>
__host__ __device__ constexpr int b_bytes() {
  return KN ? C::BK * b_pitch<C, true>() * 4 : C::BN * b_pitch<C, false>() * 4;
}
template <class C, bool KM, bool KN>
__host__ __device__ constexpr int stage_bytes() {
  return a_bytes<C, KM>() + b_bytes<C, KN>();
}

// A run of elements in device memory: where it starts and how many of its
// elements are in range (<= 0: none).
struct Run {
  const void* p;
  long long n;
};

__device__ __forceinline__ void copy_one(float* dst, const float* src,
                                         bool ok) {
  cp_async4(dst, src, ok ? 4 : 0);
}
// no cp.async below 4 bytes: a 2-byte aligned bf16 is copied synchronously
// (only odd small shapes take this path)
__device__ __forceinline__ void copy_one(__nv_bfloat16* dst,
                                         const __nv_bfloat16* src, bool ok) {
  *reinterpret_cast<uint16_t*>(dst) =
      ok ? *reinterpret_cast<const uint16_t*>(src) : uint16_t(0);
}

// Stage a ROWS x COLS tile of T into shared-memory rows of P elements;
// at(r, j) is the run from element j of tile row r on.
template <typename T, int ROWS, int COLS, int P, int NT, class At>
__device__ __forceinline__ void stage_tile(T* s, bool vec, const At& at) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  if (vec) {
    constexpr int CPR = COLS / E;
    static_assert((ROWS * CPR) % NT == 0, "chunks divide over the threads");
#pragma unroll
    for (int i = 0; i < ROWS * CPR / NT; ++i) {
      const int c = threadIdx.x + i * NT;
      const int r = c / CPR, j = (c % CPR) * E;
      const Run run = at(r, j);
      const int n = run.n <= 0 ? 0 : (run.n >= E ? E : static_cast<int>(run.n));
      cp_async16(s + r * P + j, run.p, n * static_cast<int>(sizeof(T)));
    }
  } else {
    static_assert((ROWS * COLS) % NT == 0, "elements divide over the threads");
#pragma unroll 4
    for (int i = 0; i < ROWS * COLS / NT; ++i) {
      const int e = threadIdx.x + i * NT;
      const int r = e / COLS, j = e % COLS;
      const Run run = at(r, j);
      copy_one(s + r * P + j, static_cast<const T*>(run.p), run.n > 0);
    }
  }
}

__device__ __forceinline__ long long row_off(const MmaSeg& sg, long long n) {
  if (sg.a_b == 0) return n * sg.a_sb;
  const unsigned q = static_cast<unsigned>(n) / static_cast<unsigned>(sg.a_b);
  const unsigned r = static_cast<unsigned>(n) - q * static_cast<unsigned>(sg.a_b);
  return q * sg.a_st + r * sg.a_sb;
}

// Where the CTA's block and reduction range lie.
struct MmaCtx {
  long long m0, k_lo, k_hi, M;
  int n0, N, gap_at, gap;
};

// Stage the A slice of reduction tile k0 (segment-local for MK, from k_lo
// for KM) of segment sg, elements of type T.
template <class C, typename T, bool KM>
__device__ __forceinline__ void stage_a(unsigned char* st, const MmaSeg& sg,
                                        const MmaCtx& c, int k0) {
  T* s = reinterpret_cast<T*>(st);
  const T* a = static_cast<const T*>(sg.a);
  constexpr int P = a_pitch<C, T, KM>();
  if (KM) {
    stage_tile<T, C::BK, C::BM, P, C::NT>(s, sg.a_vec, [&](int r, int j) {
      const long long k = c.k_lo + k0 + r;
      const long long m = c.m0 + j;
      if (k >= c.k_hi || m >= c.M) return Run{a, 0};
      return Run{a + row_off(sg, k) + m, c.M - m};
    });
  } else {
    stage_tile<T, C::BM, C::BK, P, C::NT>(s, sg.a_vec, [&](int r, int j) {
      const long long m = c.m0 + r;
      const int k = k0 + j;
      if (m >= c.M || k >= sg.K) return Run{a, 0};
      return Run{a + row_off(sg, m) + k, sg.K - k};
    });
  }
}

template <class C, bool KM, bool KN>
__device__ __forceinline__ void stage_b(unsigned char* st, const MmaSeg& sg,
                                        const MmaCtx& c, int k0) {
  float* s = reinterpret_cast<float*>(st + a_bytes<C, KM>());
  const float* b = sg.b;
  if (KN) {
    const long long kb = (KM ? c.k_lo : 0) + k0;
    const long long k_end = KM ? c.k_hi : sg.K;
    stage_tile<float, C::BK, C::BN, b_pitch<C, true>(), C::NT>(
        s, sg.b_vec, [&](int r, int j) {
          const long long k = kb + r;
          const int n = c.n0 + j;
          if (k >= k_end || n >= c.N) return Run{b, 0};
          const int col = n < c.gap_at ? n : n + c.gap;
          return Run{b + k * sg.ldb + col, c.N - n};
        });
  } else {
    stage_tile<float, C::BN, C::BK, b_pitch<C, false>(), C::NT>(
        s, sg.b_vec, [&](int r, int j) {
          const int n = c.n0 + r;
          const int k = k0 + j;
          if (n >= c.N || k >= sg.K) return Run{b, 0};
          return Run{b + n * sg.ldb + k, sg.K - k};
        });
  }
}

__device__ __forceinline__ void frag_pair(const float* s, int i, int step,
                                          float& v0, float& v1) {
  if (step == 1) {
    const float2 v = *reinterpret_cast<const float2*>(s + i);
    v0 = v.x;
    v1 = v.y;
  } else {
    v0 = s[i];
    v1 = s[i + step];
  }
}
__device__ __forceinline__ void frag_pair(const __nv_bfloat16* s, int i,
                                          int step, float& v0, float& v1) {
  if (step == 1) {
    const uint32_t v = *reinterpret_cast<const uint32_t*>(s + i);
    v0 = __uint_as_float(v << 16);
    v1 = __uint_as_float(v & 0xffff0000u);
  } else {
    v0 = smem_f32(s, i);
    v1 = smem_f32(s, i + step);
  }
}

// acc += the stage's A (type T) B, 3xTF32 (2 products for bf16 A). The
// tensor cores round their sums toward zero: over a reduction of thousands
// of mmas that bias adds up (2.5e-4 of the largest dW at fig_5 width), so
// the stage's BK-deep sum is formed in `part` from 0 and added to acc by
// float32 adds that round to nearest.
template <class C, typename T, bool KM, bool KN>
__device__ __forceinline__ void mma_stage(const unsigned char* st,
                                          float (&acc)[C::MI][C::NI][4]) {
  const T* sa = reinterpret_cast<const T*>(st);
  const float* sb = reinterpret_cast<const float*>(st + a_bytes<C, KM>());
  constexpr int PA = a_pitch<C, T, KM>();
  constexpr int PB = b_pitch<C, KN>();
  constexpr bool EXACT_A = is_bf16<T>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / C::WARPS_N) * C::WM, wn = (warp % C::WARPS_N) * C::WN;
  float part[C::MI][C::NI][4];
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < C::NI; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) part[mi][ni][q] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < C::BK; kk += 8) {
    const int k = kk + 2 * t;  // slots t and t + 4: columns k and k + 1
    uint32_t ah[C::MI][4], al[C::MI][4], bh[C::NI][2], bl[C::NI][2];
#pragma unroll
    for (int mi = 0; mi < C::MI; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows g and g + 8: registers h, h + 2
        const int m = wm + mi * 16 + g + h * 8;
        float v0, v1;
        frag_pair(sa, KM ? k * PA + m : m * PA + k, KM ? PA : 1, v0, v1);
        if (EXACT_A) {
          ah[mi][h] = __float_as_uint(v0);
          ah[mi][h + 2] = __float_as_uint(v1);
        } else {
          split_tf32(v0, ah[mi][h], al[mi][h]);
          split_tf32(v1, ah[mi][h + 2], al[mi][h + 2]);
        }
      }
    }
#pragma unroll
    for (int ni = 0; ni < C::NI; ++ni) {
      const int n = wn + ni * 8 + g;
      float v0, v1;
      frag_pair(sb, KN ? k * PB + n : n * PB + k, KN ? PB : 1, v0, v1);
      split_tf32(v0, bh[ni][0], bl[ni][0]);
      split_tf32(v1, bh[ni][1], bl[ni][1]);
    }
    // the small terms first; each pass runs over all tiles, so that
    // consecutive mmas are independent
    if (!EXACT_A) {
#pragma unroll
      for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < C::NI; ++ni) mma_tf32(part[mi][ni], al[mi], bh[ni]);
    }
#pragma unroll
    for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < C::NI; ++ni) mma_tf32(part[mi][ni], ah[mi], bl[ni]);
#pragma unroll
    for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < C::NI; ++ni) mma_tf32(part[mi][ni], ah[mi], bh[ni]);
  }
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < C::NI; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] += part[mi][ni][q];
}

// One CTA of out = A B (see MmaArgs). Segment 0's A is TA, segment 1's
// float. The ring: tile i + STAGES - 1 is copied while tile i is
// multiplied; one barrier a tile.
template <class C, typename TA, bool KM, bool KN>
__global__ void __launch_bounds__(C::NT, C::MIN_BLOCKS)
    mma_gemm_kernel(const MmaArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int STAGE = stage_bytes<C, KM, KN>();
  constexpr int PB = b_pitch<C, KN>();
  const MmaSeg s0 = p.seg[0];
  const MmaSeg s1 = p.seg[1];
  // column blocks run fastest, so that the CTAs that read the same A rows
  // run together and A comes from device memory once
  const int n_tn = (p.N + C::BN - 1) / C::BN;
  MmaCtx c;
  c.m0 = static_cast<long long>(blockIdx.x / n_tn) * C::BM;
  c.n0 = (blockIdx.x % n_tn) * C::BN;
  c.M = p.M;
  c.N = p.N;
  c.gap_at = p.gap_at;
  c.gap = p.gap;
  int nk0, nk1 = 0, kt0 = 0;
  if (KM) {
    c.k_lo = static_cast<long long>(blockIdx.z) * p.k_per;
    c.k_hi = c.k_lo + p.k_per < p.k_total ? c.k_lo + p.k_per : p.k_total;
    nk0 = c.k_hi > c.k_lo
              ? static_cast<int>((c.k_hi - c.k_lo + C::BK - 1) / C::BK)
              : 0;
  } else {
    c.k_lo = c.k_hi = 0;
    nk0 = (s0.K + C::BK - 1) / C::BK;
    nk1 = (s1.K + C::BK - 1) / C::BK;
  }
  int kt1 = nk0 + nk1;
  if (!KM && p.kt_per > 0) {
    kt0 = blockIdx.z * p.kt_per;
    kt1 = kt0 + p.kt_per < kt1 ? kt0 + p.kt_per : kt1;
  }
  const int n_it = kt1 > kt0 ? kt1 - kt0 : 0;

  // reduction tile kt into ring slot i % STAGES
  auto issue = [&](int i) {
    unsigned char* st = smem + (i % C::STAGES) * STAGE;
    const int kt = kt0 + i;
    if (kt < nk0) {
      stage_a<C, TA, KM>(st, s0, c, kt * C::BK);
      stage_b<C, KM, KN>(st, s0, c, kt * C::BK);
    } else {
      stage_a<C, float, KM>(st, s1, c, (kt - nk0) * C::BK);
      stage_b<C, KM, KN>(st, s1, c, (kt - nk0) * C::BK);
    }
  };

  float acc[C::MI][C::NI][4];
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < C::NI; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.0f;
  // the bias row (KM): the CTAs of the first row block also sum B's
  // columns, thread (rg, bn) rows rg, rg + NG, ... of column bn
  constexpr int NG = C::NT / C::BN;
  const bool do_bias = KM && c.m0 == 0;
  const int bn = threadIdx.x % C::BN, rg = threadIdx.x / C::BN;
  float bsum = 0.0f;

#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < n_it) issue(s);
    cp_async_commit();
  }
  for (int i = 0; i < n_it; ++i) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();  // tile i landed; every warp is done with i - 1
    if (i + C::STAGES - 1 < n_it) issue(i + C::STAGES - 1);
    cp_async_commit();
    const unsigned char* st = smem + (i % C::STAGES) * STAGE;
    if (do_bias) {
      const float* sb = reinterpret_cast<const float*>(st + a_bytes<C, KM>());
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < C::BK / NG; ++j) s += sb[(rg + j * NG) * PB + bn];
      bsum += s;
    }
    if (is_bf16<TA>() && kt0 + i < nk0) {
      mma_stage<C, TA, KM, KN>(st, acc);
    } else {
      mma_stage<C, float, KM, KN>(st, acc);
    }
  }
  cp_async_wait<0>();

  float* out = p.out + blockIdx.z * p.out_z;
  if (do_bias) {
    static_assert(C::NT % C::BN == 0 && C::BK % NG == 0, "bias row layout");
    float* red = reinterpret_cast<float*>(smem);
    __syncthreads();  // every warp is done with the ring
    red[rg * C::BN + bn] = bsum;
    __syncthreads();
    const int n = c.n0 + bn;
    if (rg == 0 && n < c.N) {
      float v = 0.0f;
      for (int r = 0; r < NG; ++r) v += red[r * C::BN + bn];
      out[c.M * p.ldo + p.out_col + n] = v;
    }
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / C::WARPS_N) * C::WM, wn = (warp % C::WARPS_N) * C::WN;
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = c.m0 + wm + mi * 16 + g + h * 8;
      if (m >= c.M) continue;
#pragma unroll
      for (int ni = 0; ni < C::NI; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = c.n0 + wn + ni * 8 + 2 * t + e;
          if (n >= c.N) continue;
          float v = acc[mi][ni][2 * h + e];
          if (p.bias0 != nullptr) v += p.bias0[n];
          if (p.bias1 != nullptr) v += p.bias1[n];
          out[m * p.ldo + p.out_col + n] = v;
        }
      }
    }
  }
}

__host__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Launch out = A B over a grid of (ceil(M / BM) ceil(N / BN), n_z).
template <class C, typename TA, bool KM, bool KN>
int launch_mma(const MmaArgs& p, int n_z, cudaStream_t stream) {
  constexpr int SMEM = C::STAGES * stage_bytes<C, KM, KN>();
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        mma_gemm_kernel<C, TA, KM, KN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  if (p.M <= 0 || p.N <= 0) return 0;
  const long long tiles = (p.M + C::BM - 1) / C::BM *
                          ((p.N + C::BN - 1) / C::BN);
  const dim3 grid(static_cast<unsigned>(tiles), 1, n_z);
  mma_gemm_kernel<C, TA, KM, KN><<<grid, C::NT, SMEM, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The wgmma route (see "Two kernels" at the head): out = A W for a weight W
// ---------------------------------------------------------------------------

// Weight products of at least this many rows (a call's T B) take
// wgmma_gemm_kernel, fewer mma_gemm_kernel. `python tools/port_probes.py
// sweep` times both routes on T = 1 calls of 128-16384 rows at the cells'
// widths: wgmma's products are the faster at every count, but below ~1024
// rows a call's own host work (the image's scratch, its pass) takes more
// than they save, and a stream's B = 1 step waits on the host.
#ifndef GRU_WGMMA_MIN_ROWS
#define GRU_WGMMA_MIN_ROWS 1024
#endif

// the ring's stages, and the registers of a producer and a consumer thread
// (setmaxnreg), the best measured (`port_probes.py fwd`: 4 stages with
// 56 / 224 ran 2-12 % slower)
#ifndef GRU_WGMMA_STAGES
#define GRU_WGMMA_STAGES 3
#endif
#ifndef GRU_WGMMA_REGS
#define GRU_WGMMA_REGS 72, 216
#endif

namespace wg {
constexpr int BM = 128, BN = 128, BK = 32, STAGES = GRU_WGMMA_STAGES;
constexpr int NT = 384;  // a producer warpgroup, then two consumers
constexpr int PLANE = BK * BN;      // floats of one plane of an image block
constexpr int BLOCK = 2 * PLANE;    // an image block: hi plane, lo plane
constexpr int B_BYTES = BLOCK * 4;  // a stage's B, one bulk copy
// the producer's 128 threads stage A as mma_gemm_kernel's CTAs do
using Load = MmaCfg<BM, BN, 2, 2, STAGES, 1>;
constexpr int A_BYTES = a_bytes<Load, false>();
constexpr int STAGE = A_BYTES + B_BYTES;
constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8;  // ring, mbarriers
// K-major core matrices (8 columns x 4 k, 128 bytes) of a plane: k chunk
// kc (4 deep) at kc * LBO bytes, column group at 8-column steps of SBO
constexpr int SBO = 128, LBO = (BN / 8) * SBO;
// the epilogue's BM x BN block in the ring, rows of TILE_PITCH floats
// (8 mod 32: the fragments' float2 writes are free of bank conflicts)
constexpr int TILE_PITCH = BN + 8;
static_assert(BM * TILE_PITCH * 4 <= STAGES * STAGE, "the block fits");
constexpr int REGS[2] = {GRU_WGMMA_REGS};
constexpr int REG_PRODUCER = REGS[0], REG_CONSUMER = REGS[1];
static_assert(A_BYTES % 128 == 0 && STAGE % 128 == 0, "aligned stages");
// a CTA of 384 threads starts with 168 registers a thread (65536 / 384,
// rounded down to 8); setmaxnreg moves them from producer to consumers
static_assert(REG_PRODUCER * 128 + REG_CONSUMER * 256 <= 168 * 384,
              "setmaxnreg.inc would wait for registers forever");
}  // namespace wg

// A weight's image: the columns of W (K x n_cols, element (k, c)) in two
// runs, [0, c_split) and [c_split, n_cols), each cut into blocks of BN
// columns (nb0 and nb1 blocks, the last of each zero padded); block b,
// reduction tile kt (BK deep, zero padded past K) at p + (b nkt + kt)
// BLOCK, a hi plane, then a lo plane. A plane holds image position
// (kc, j, q) (k chunk kc < 8, block column j < BN, q < 4) at float
// kc (BN / 8) 32 + (j / 8) 32 + (j % 8) 4 + q: wgmma's K-major layout
// without swizzle, its core matrices 128 contiguous bytes, so its reads
// are free of bank conflicts. Chunks 2s and 2s + 1 are k8 step s, whose
// slots t and t + 4 hold k = 8s + 2t and 8s + 2t + 1: the A fragments take
// columns 2t and 2t + 1 in one read, as mma_stage's do.
struct WImage {
  float* p;
  int K, n_cols, c_split;
  int nb0, nb1, nkt;
};

__host__ __device__ inline WImage wimage(float* p, int K, int n_cols,
                                         int c_split) {
  WImage im;
  im.p = p;
  im.K = K;
  im.n_cols = n_cols;
  im.c_split = c_split;
  im.nb0 = (c_split + wg::BN - 1) / wg::BN;
  im.nb1 = (n_cols - c_split + wg::BN - 1) / wg::BN;
  im.nkt = (K + wg::BK - 1) / wg::BK;
  return im;
}

__host__ __device__ inline long long wimage_floats(const WImage& im) {
  return static_cast<long long>(im.nb0 + im.nb1) * im.nkt * wg::BLOCK;
}

// Write the image of W: element (k, c) = w[k ldw + c], or w[c ldw + k]
// when nk (dx's Wi^T is Wi read by rows). One thread an image float.
__global__ void presplit_kernel(const WImage im, const float* __restrict__ w,
                                long long ldw, int nk) {
  const long long total = wimage_floats(im);
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += step) {
    const long long tile = i / wg::BLOCK;
    const int within = static_cast<int>(i - tile * wg::BLOCK);
    const int plane = within / wg::PLANE, e = within % wg::PLANE;
    const int b = static_cast<int>(tile / im.nkt);
    const int kt = static_cast<int>(tile - static_cast<long long>(b) * im.nkt);
    const int cm = e / 32, j = (cm % (wg::BN / 8)) * 8 + (e / 4) % 8;
    const int kc = cm / (wg::BN / 8), slot = (kc & 1) * 4 + e % 4;
    const int k = kt * wg::BK + (kc >> 1) * 8 +
                  (slot < 4 ? 2 * slot : 2 * (slot - 4) + 1);
    const bool first = b < im.nb0;
    const int c = first ? b * wg::BN + j
                        : im.c_split + (b - im.nb0) * wg::BN + j;
    const int c_end = first ? im.c_split : im.n_cols;
    float v = 0.0f;
    if (k < im.K && c < c_end) {
      v = nk ? w[static_cast<long long>(c) * ldw + k]
             : w[static_cast<long long>(k) * ldw + c];
    }
    uint32_t hi, lo;
    split_tf32(v, hi, lo);
    im.p[i] = __uint_as_float(plane == 0 ? hi : lo);
  }
}

// A launch of wgmma_gemm_kernel: out[m, out_col + n] = sum over segments
// of A W + bias0[n] + bias1[n], m < M, n < N. Segment s's A as in MmaSeg
// (its b fields unused; every A run 16-byte aligned), its W the image
// blocks from img[s] on (nkt[s] tiles a block). The launch's column block
// jb holds columns jb BN on below split_blk, split_n + (jb - split_blk) BN
// on from it (the forward's x Wi runs over both runs of Wi's image).
struct WgArgs {
  MmaSeg seg[2];
  const float* img[2];
  int nkt[2];
  const float* bias0;
  const float* bias1;
  float* out;
  long long ldo;
  int out_col;
  long long M;
  int N, n_blk, split_blk, split_n;
};

__device__ __forceinline__ void mbar_init(uint64_t* b, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* b, unsigned parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(b)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(b))
               : "memory");
}

// an arrival that also expects `bytes` of asynchronous copies
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* b, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(b)),
               "r"(bytes)
               : "memory");
}

// an arrival once the thread's cp.asyncs so far have landed
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* b) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(b))
               : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(b))
      : "memory");
}

// the shared-memory matrix descriptor of a K-major plane at byte address
// `addr`: no swizzle, LBO and SBO in 16-byte units
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(wg::LBO >> 4) << 16) |
         (static_cast<uint64_t>(wg::SBO >> 4) << 32);
}

// a barrier of the two consumer warpgroups (256 threads, barrier 1)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep a register's value in place across the asynchronous wgmmas
__device__ __forceinline__ void reg_fence(float& v) {
  asm volatile("" : "+f"(v)::"memory");
}
__device__ __forceinline__ void reg_fence(uint32_t& v) {
  asm volatile("" : "+r"(v)::"memory");
}

// d = A B (+ d when scale_d): A the warpgroup's 64 x 8 TF32 fragment (per
// warp as mma.sync.m16n8k8's A), B the 8 x 128 K-major plane at desc
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// part = the stage's A (type T) W for the warpgroup's 64 rows from row0,
// 3xTF32 (2 products for bf16 A), in mma_stage's order: for each k8 step
// lo_a hi_b, hi_a lo_b, hi_a hi_b, the first from 0.
template <typename T>
__device__ __forceinline__ void wg_stage(const unsigned char* st, int row0,
                                         float (&part)[64]) {
  constexpr bool EXACT_A = is_bf16<T>();
  constexpr int PA = a_pitch<wg::Load, T, false>();
  const T* sa = reinterpret_cast<const T*>(st);
  const uint32_t sb = smem_u32(st + wg::A_BYTES);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t ah[4][4], al[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows g and g + 8: registers h, h + 2
      float v0, v1;
      frag_pair(sa, (row0 + g + 8 * h) * PA + kk * 8 + 2 * t, 1, v0, v1);
      if (EXACT_A) {
        ah[kk][h] = __float_as_uint(v0);
        ah[kk][h + 2] = __float_as_uint(v1);
      } else {
        split_tf32(v0, ah[kk][h], al[kk][h]);
        split_tf32(v1, ah[kk][h + 2], al[kk][h + 2]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 64; ++q) reg_fence(part[q]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t dh = wg_desc(sb + kk * 2 * wg::LBO);
    const uint64_t dl = wg_desc(sb + wg::PLANE * 4 + kk * 2 * wg::LBO);
    int acc_d = kk > 0;
    if (!EXACT_A) {
      wgmma_tf32(part, al[kk], dh, acc_d);
      acc_d = 1;
    }
    wgmma_tf32(part, ah[kk], dl, acc_d);
    wgmma_tf32(part, ah[kk], dh, 1);
  }
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int q = 0; q < 64; ++q) reg_fence(part[q]);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      reg_fence(ah[kk][r]);
      if (!EXACT_A) reg_fence(al[kk][r]);
    }
}

// One 128 x 128 block of out (see WgArgs). Segment 0's A is TA, segment
// 1's float. Warpgroup 0 produces: stage i of the ring is tile i's A (its
// 128 threads' cp.asyncs, each arriving on full[i % STAGES] when its
// copies land) and W's image block (one bulk copy, its bytes expected by
// thread 0's arrival), refilled once both consumers' 8 warps arrive on
// empty[]. Warpgroups 1 and 2 consume rows 0-63 and 64-127.
template <typename TA>
__global__ void __launch_bounds__(wg::NT, 1)
    wgmma_gemm_kernel(const WgArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + wg::STAGES * wg::STAGE);
  uint64_t* empty = full + wg::STAGES;
  // column blocks run fastest, so that the CTAs that read the same A rows
  // run together and A comes from device memory once
  const int jb = blockIdx.x % p.n_blk;
  MmaCtx c = {};
  c.m0 = static_cast<long long>(blockIdx.x / p.n_blk) * wg::BM;
  c.M = p.M;
  const int nk0 = (p.seg[0].K + wg::BK - 1) / wg::BK;
  const int n_it = nk0 + (p.seg[1].K + wg::BK - 1) / wg::BK;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < wg::STAGES; ++s) {
      mbar_init(full + s, 128 + 1);
      mbar_init(empty + s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        wg::REG_PRODUCER));
    for (int i = 0; i < n_it; ++i) {
      const int s = i % wg::STAGES;
      if (i >= wg::STAGES) mbar_wait(empty + s, ((i / wg::STAGES) - 1) & 1);
      unsigned char* st = smem + s * wg::STAGE;
      const int seg = i < nk0 ? 0 : 1;
      const int kt = seg ? i - nk0 : i;
      if (seg == 0) {
        stage_a<wg::Load, TA, false>(st, p.seg[0], c, kt * wg::BK);
      } else {
        stage_a<wg::Load, float, false>(st, p.seg[1], c, kt * wg::BK);
      }
      mbar_arrive_cp_async(full + s);
      if (threadIdx.x == 0) {
        mbar_arrive_tx(full + s, wg::B_BYTES);
        bulk_copy(st + wg::A_BYTES,
                  p.img[seg] + (static_cast<long long>(jb) * p.nkt[seg] + kt) *
                                   wg::BLOCK,
                  wg::B_BYTES, full + s);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        wg::REG_CONSUMER));
    const int ct = threadIdx.x - 128;
    const int row0 = (ct / 128) * 64 + ((ct / 32) % 4) * 16;
    const int lane = threadIdx.x & 31;
    float acc[64], part[64];
#pragma unroll
    for (int q = 0; q < 64; ++q) acc[q] = part[q] = 0.0f;
    for (int i = 0; i < n_it; ++i) {
      const int s = i % wg::STAGES;
      mbar_wait(full + s, (i / wg::STAGES) & 1);
      const unsigned char* st = smem + s * wg::STAGE;
      if (is_bf16<TA>() && i < nk0) {
        wg_stage<TA>(st, row0, part);
      } else {
        wg_stage<float>(st, row0, part);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);
#pragma unroll
      for (int q = 0; q < 64; ++q) acc[q] += part[q];
    }

    // The epilogue goes through shared memory (the ring, free once both
    // consumers are past their last stage), so that a warp writes 32
    // consecutive floats of a row at a time. acc[4 j + 2 h + e] is row
    // g + 8 h, column 8 j + 2 t + e of the warp's 16 x 128 block.
    consumers_sync();
    float* tile = reinterpret_cast<float*>(smem);
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        *reinterpret_cast<float2*>(
            tile + (row0 + g + 8 * h) * wg::TILE_PITCH + 8 * j + 2 * t) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    consumers_sync();
    const bool first = jb < p.split_blk;
    const int n0 =
        first ? jb * wg::BN : p.split_n + (jb - p.split_blk) * wg::BN;
    const int n_end = first ? p.split_n : p.N;
    // a lane's columns n0 + 32 q + lane and their biases
    float b0[wg::BN / 32], b1[wg::BN / 32];
#pragma unroll
    for (int q = 0; q < wg::BN / 32; ++q) {
      const int n = n0 + q * 32 + lane;
      const bool in = n < n_end;
      b0[q] = in && p.bias0 != nullptr ? p.bias0[n] : 0.0f;
      b1[q] = in && p.bias1 != nullptr ? p.bias1[n] : 0.0f;
    }
    for (int r = ct / 32; r < wg::BM; r += 8) {
      const long long m = c.m0 + r;
      if (m >= p.M) break;
      float* out = p.out + m * p.ldo + p.out_col;
#pragma unroll
      for (int q = 0; q < wg::BN / 32; ++q) {
        const int n = n0 + q * 32 + lane;
        if (n >= n_end) continue;
        // the biases added one after the other, as mma_gemm_kernel does
        float v = tile[r * wg::TILE_PITCH + q * 32 + lane];
        if (p.bias0 != nullptr) v += b0[q];
        if (p.bias1 != nullptr) v += b1[q];
        out[n] = v;
      }
    }
  }
}

// Host side: the segments and arguments of a product.

#define RETURN_IF_FAILED(expr)            \
  do {                                    \
    const int err_ = (expr);              \
    if (err_ != 0) return err_;           \
  } while (0)

#define RETURN_IF_LAUNCH_FAILED() \
  RETURN_IF_FAILED(static_cast<int>(cudaGetLastError()))

// A segment whose A rows are the data rows (t, b) of x at x + t*sx_t +
// b*sx_b, K = F; rows in one (t-major) run when sx_t = B sx_b.
template <typename T>
MmaSeg x_seg(const T* x, long long sx_t, long long sx_b, int B, int F) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  MmaSeg s = {};
  s.a = x;
  s.a_b = sx_t == B * sx_b ? 0 : B;
  s.a_st = sx_t;
  s.a_sb = sx_b;
  s.a_vec = aligned16(x) && sx_t % E == 0 && sx_b % E == 0;
  s.K = F;
  return s;
}

// A segment over a row-major float matrix: row n at a + n*lda.
MmaSeg f32_seg(const float* a, long long lda, int K) {
  MmaSeg s = {};
  s.a = a;
  s.a_sb = lda;
  s.a_vec = aligned16(a) && lda % 4 == 0;
  s.K = K;
  return s;
}

void set_b(MmaSeg& s, const float* b, long long ldb, bool extra_ok = true) {
  s.b = b;
  s.ldb = ldb;
  s.b_vec = extra_ok && aligned16(b) && ldb % 4 == 0;
}

MmaArgs out_args(float* out, long long ldo, int out_col, long long M, int N) {
  MmaArgs p = {};
  p.out = out;
  p.ldo = ldo;
  p.out_col = out_col;
  p.M = M;
  p.N = N;
  p.gap_at = N;
  return p;
}

// Weight products launched by route since the last read of gru_*_routes:
// [0] wgmma_gemm_kernel, [1] mma_gemm_kernel.
long long g_routes[2] = {0, 0};

// Whether a call's weight products of M rows take wgmma (see the head).
bool wgmma_rows(long long M) { return M >= GRU_WGMMA_MIN_ROWS; }

// Write the image `im` of w (element (k, c) at w[k ldw + c], or w[c ldw +
// k] when nk).
int presplit(const WImage& im, const float* w, long long ldw, bool nk,
             cudaStream_t stream) {
  const long long n = wimage_floats(im);
  const long long blocks = (n + 255) / 256;
  presplit_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), 256,
                    0, stream>>>(im, w, ldw, nk ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename TA>
int launch_wgmma(const WgArgs& p, cudaStream_t stream) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        wgmma_gemm_kernel<TA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        wg::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  if (p.M <= 0 || p.N <= 0) return 0;
  const long long tiles = (p.M + wg::BM - 1) / wg::BM * p.n_blk;
  wgmma_gemm_kernel<TA><<<static_cast<unsigned>(tiles), wg::NT, wg::SMEM,
                          stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// out = A W as launch_mma<MmaBig, TA, false, KN> takes it (p: W's columns
// [c_lo, c_lo + N), c_lo 0 or the images' c_split), or, when on_wgmma and
// every A run is 16-byte aligned, on wgmma from the images im0 and im1 of
// the segments' weights (null where a segment is empty).
template <typename TA, bool KN>
int weight_product(const MmaArgs& p, const WImage* im0, const WImage* im1,
                   int c_lo, bool on_wgmma, cudaStream_t stream) {
  for (int s = 0; s < 2; ++s) {
    if (p.seg[s].K > 0 && !p.seg[s].a_vec) on_wgmma = false;
  }
  if (!on_wgmma) {
    ++g_routes[1];
    return launch_mma<MmaBig, TA, false, KN>(p, 1, stream);
  }
  ++g_routes[0];
  const WImage& im = im0 != nullptr ? *im0 : *im1;
  WgArgs a = {};
  int first;
  if (c_lo == 0) {
    first = 0;
    a.n_blk = p.N > im.c_split ? im.nb0 + im.nb1 : im.nb0;
    a.split_blk = im.nb0;
    a.split_n = im.c_split < p.N ? im.c_split : p.N;
  } else {
    first = im.nb0;
    a.n_blk = a.split_blk = im.nb1;
    a.split_n = p.N;
  }
  const WImage* ims[2] = {im0, im1};
  for (int s = 0; s < 2; ++s) {
    a.seg[s] = p.seg[s];
    if (ims[s] != nullptr && p.seg[s].K > 0) {
      a.img[s] = ims[s]->p + static_cast<long long>(first) * ims[s]->nkt *
                                 wg::BLOCK;
      a.nkt[s] = ims[s]->nkt;
    }
  }
  a.bias0 = p.bias0;
  a.bias1 = p.bias1;
  a.out = p.out;
  a.ldo = p.ldo;
  a.out_col = p.out_col;
  a.M = p.M;
  a.N = p.N;
  return launch_wgmma<TA>(a, stream);
}

// *counts = g_routes; zeroed after the read when `reset`
void read_routes(long long* counts, int reset) {
  counts[0] = g_routes[0];
  counts[1] = g_routes[1];
  if (reset) g_routes[0] = g_routes[1] = 0;
}

// ---------------------------------------------------------------------------
// The sweeps' step kernels split K over a thread-block cluster where a
// step has few output tiles (gru_fwd.cu's forward step, gru_bwd.cu's
// backward step): rank r of a cluster of S CTAs multiplies its run of K's
// tiles, and the ranks sum their partial tiles through distributed shared
// memory in rank order. One launcher for both, from a description K of
// the kernel: K::Args its argument, K::kernel<S>() its instance for
// clusters of S, K::NT threads, K::SMEM bytes of dynamic shared memory
// (its ring), K::MIN_BLOCKS CTAs an SM, K::MAX_SPLIT the largest S,
// K::counts() its launches by S.
// ---------------------------------------------------------------------------

int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v;
  }();
  return n;
}

// A launch of `ctas` CTAs of K's kernel in clusters of S (attr: the
// launch's attributes, kept by the caller), the clusters placed by load
// balancing, which spreads them over the SMs as a plain launch's CTAs
// are: with the default placement 64 clusters of 4 backward step CTAs
// left 8 of the H100's SMs with 3 CTAs and 8 with none, and their step
// took 38.2 µs against 29.9 (PERF.md, section 6).
template <class K>
cudaLaunchConfig_t cluster_config(long long ctas, int S, cudaStream_t stream,
                                  cudaLaunchAttribute (&attr)[2]) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(ctas));
  cfg.blockDim = dim3(K::NT);
  cfg.dynamicSmemBytes = K::SMEM;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeClusterSchedulingPolicyPreference;
  attr[1].val.clusterSchedulingPolicyPreference =
      cudaClusterSchedulingPolicyLoadBalancing;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return cfg;
}

// The kernel's dynamic shared memory (over the 48 KB a launch gets
// without asking) and, for a cluster of 16, the non-portable cluster
// size; set once a process for each S
template <class K, int S>
cudaError_t step_attrs() {
  static const cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(
        K::template kernel<S>(), cudaFuncAttributeMaxDynamicSharedMemorySize,
        K::SMEM);
    if (e == cudaSuccess && S > 8) {
      e = cudaFuncSetAttribute(K::template kernel<S>(),
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    }
    return e;
  }();
  return err;
}

// How many clusters of S CTAs the card holds at once, read once a process
// (0 where the card takes no such cluster)
template <class K, int S>
int max_clusters() {
  static const int n = [] {
    int v = 0;
    cudaLaunchAttribute attr[2];
    const cudaLaunchConfig_t cfg = cluster_config<K>(S, S, nullptr, attr);
    if (step_attrs<K, S>() != cudaSuccess ||
        cudaOccupancyMaxActiveClusters(&v, K::template kernel<S>(), &cfg) !=
            cudaSuccess) {
      cudaGetLastError();  // a refused query is no launch error
      v = 0;
    }
    return v;
  }();
  return n;
}

template <class K, int S = K::MAX_SPLIT>
int clusters_of(int s) {
  if constexpr (S < 2) {
    return 0;
  } else {
    return s == S ? max_clusters<K, S>() : clusters_of<K, S / 2>(s);
  }
}

// The cluster size a step of `tiles` output tiles and n_k k-tiles splits
// K over: the largest power of two S <= K::MAX_SPLIT whose tiles x S CTAs
// fit in one wave of K::MIN_BLOCKS CTAs on each SM, whose clusters all
// fit on the card at once, and that leaves every rank a k-tile. From the
// shape and the card alone, so that a run repeats its sums bit for bit.
template <class K>
int step_split(long long tiles, int n_k) {
  const long long wave = static_cast<long long>(K::MIN_BLOCKS) * sm_count();
  for (int s = K::MAX_SPLIT; s > 1; s /= 2) {
    if (s <= n_k && tiles * s <= wave && tiles <= clusters_of<K>(s)) {
      return s;
    }
  }
  return 1;
}

// The index k of S = 2^k in the libraries' step counters
constexpr int split_index(int S) {
  return S <= 1 ? 0 : 1 + split_index(S / 2);
}

// One step: `tiles` output tiles, each a cluster of `split` CTAs (a plain
// launch at 1), counted in K::counts()
template <class K, int S = K::MAX_SPLIT>
int launch_step(const typename K::Args& p, long long tiles, int split,
                cudaStream_t stream) {
  if constexpr (S > 1) {
    if (split != S) return launch_step<K, S / 2>(p, tiles, split, stream);
  }
  RETURN_IF_FAILED(static_cast<int>(step_attrs<K, S>()));
  if (tiles <= 0) return 0;
  if constexpr (S == 1) {
    const auto kernel = K::template kernel<1>();
    kernel<<<static_cast<unsigned>(tiles), K::NT, K::SMEM, stream>>>(p);
  } else {
    cudaLaunchAttribute attr[2];
    const cudaLaunchConfig_t cfg = cluster_config<K>(tiles * S, S, stream,
                                                     attr);
    RETURN_IF_FAILED(static_cast<int>(
        cudaLaunchKernelEx(&cfg, K::template kernel<S>(), p)));
  }
  ++K::counts()[split_index(S)];
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
