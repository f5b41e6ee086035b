// Tensor-core products of the GRU backward (gru_bwd.cu) and of the
// forward kernels (gru_fwd.cu): out = A B over 3xTF32 mma.sync,
// operands staged by a multi-stage cp.async ring.
//
// Precision. Each float32 operand value v is split in registers, between
// the shared-memory read and the mma, into hi = tf32(v) and lo =
// tf32(v - hi); the product is lo_a hi_b + hi_a lo_b + hi_a hi_b with float32
// accumulation (the lo_a lo_b term, ~2^-22 of |ab|, is dropped). That keeps
// float32-class products (relative error ~1e-7 of the largest output on a
// long reduction, below float32 accumulation's own) where one TF32 or bf16
// pass errs ~3e-4 or ~3e-3. A bf16 A operand (the frames, bf16 x) is exact
// in TF32: its lo is 0, lo_a hi_b is skipped, and its products run as two
// TF32 passes (495/2 TFLOP/s float32-equivalent, against 495/3 for a float32
// A). bf16x3 was the faster candidate (989/3 TFLOP/s equivalent) but errs
// ~5e-6 of the largest output per product, too close to the 1e-5 that the
// card tests hold the gradients to.
//
// Why mma.sync and not wgmma. Every operand passes through registers for
// the split, and the weight-gradient products read both operands M- or
// N-major (x^T G), which wgmma accepts for TF32 only K-major from shared
// memory in its core-matrix layout: each stage would need a second pass
// that splits and transposes into that layout. mma.sync.m16n8k8 takes its
// fragments from registers, so one padded tile layout per operand serves
// every product. wgmma is the next step (ROADMAP).
//
// Tiles. A CTA owns a BM x BN block of out, its warps WM x WN each (MI x NI
// m16n8 tiles). A stage holds a BK-deep slice of both operands as they lie
// in device memory (rows of the operand's contiguous axis), copied with
// 16-byte cp.async where every run is 16-byte aligned and with one element
// a copy otherwise; the ragged edges are zero filled by the copies' source
// size, never by padding the caller's tensors. Pitches (in elements) keep
// the fragment reads free of bank conflicts: a [row][k] tile read at
// (g, t) wants pitch = 4 mod 32 (float) or 8 mod 64 (bf16, 2 per bank), a
// [k][row] tile read at (t, g) wants 8 mod 32.

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
// -DGRU_MMA_SMALL=..., -DGRU_MMA_PASSES=1, -DGRU_MMA_SPLIT=0): `python
// tools/port_probes.py bwd` builds such variants and times them beside the
// defaults. The large products (gates, dx, dW): 8 warps of 64 x 32, 3
// stages.
#ifndef GRU_MMA_BIG
#define GRU_MMA_BIG 128, 128, 2, 4, 3, 1
#endif
// the per-step dh' product (B x H, split over K): 4 warps of 32 x 32,
// three CTAs on an SM, so that a step of B = 1000-2000 rows and H = 500
// columns fills the card
#ifndef GRU_MMA_SMALL
#define GRU_MMA_SMALL 64, 64, 2, 2, 3, 3
#endif
// Diagnostics, not float32-class: GRU_MMA_PASSES=1 runs one TF32 product
// (hi_a hi_b) in place of three; GRU_MMA_SPLIT=0 keeps the three products
// but skips the split (lo = hi), which prices the split's arithmetic.
#ifndef GRU_MMA_PASSES
#define GRU_MMA_PASSES 3
#endif
#ifndef GRU_MMA_SPLIT
#define GRU_MMA_SPLIT 1
#endif
static_assert(GRU_MMA_PASSES == 1 || GRU_MMA_PASSES == 3, "1 or 3 passes");
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
#if GRU_MMA_PASSES == 3 && GRU_MMA_SPLIT
  lo = tf32_bits(v - __uint_as_float(hi));
#else
  lo = hi;
#endif
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
    if (!EXACT_A && GRU_MMA_PASSES == 3) {
#pragma unroll
      for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < C::NI; ++ni) mma_tf32(part[mi][ni], al[mi], bh[ni]);
    }
    if (GRU_MMA_PASSES == 3) {
#pragma unroll
      for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < C::NI; ++ni)
          mma_tf32(part[mi][ni], ah[mi], bl[ni]);
    }
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

}  // namespace
