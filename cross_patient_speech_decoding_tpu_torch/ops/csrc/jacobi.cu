// Batched symmetric eigensolver (parallel round-robin Jacobi) for Hopper
// (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas kernel sweep_kernel of
// cross_patient_speech_decoding_tpu/ops/jacobi.py (launched by
// jacobi_eigh_pallas under batched_eigh): one round-robin sweep over a
// batch of small symmetric float32 matrices per launch, with A and V held
// in VMEM, R^T A R and V R formed as dense products against the step's
// permutation matrix (split three ways into bf16 for the MXU), and an XLA
// while_loop between sweeps that stops once no matrix of the batch is
// above its tolerance.
//
// Function computed (the same as jacobi_eigh_plain in ../jacobi.py, which
// the tests hold it against bit for bit): for each (Kp, Kp) matrix, Kp
// even <= 64,
//   tol = 5e-14 * max(sum A_ij^2, 1e-30)           (float64)
//   for sweep in 0 .. sweeps-1:
//     stop if sum_{i != j} A_ij^2 <= tol            (float64)
//     for step in 0 .. Kp-2, for each pair (p, q) of the step:
//       tau = (A_qq - A_pp) / (2 A_pq)
//       t = sign(tau) / (|tau| + sqrt(1 + tau^2)),  sign(0) = +1
//       t = 0 where |A_pq| < 1e-30
//       c = 1 / sqrt(1 + t^2), s = t c
//       columns p, q of A and V <- (c x - s y, c y + s x)
//       rows p, q of A          <- (c x - s y, c y + s x)
// and writes the unsorted diagonal w, V and the sweeps run. The pairs are
// the JAX package's round-robin tournament (_round_robin_pairs), which the
// kernel runs by position (see fold, below), so that the rotations and
// their order are those of the plain version. Every rotation is rounded
// op by op (__fmul_rn, __fsub_rn, ...), so no FMA contraction separates
// it from the plain version's tensor ops: the two agree bit for bit.
//
// What bounds it. Per sweep a matrix needs 9 Kp^2 (Kp-1) FLOPs, 561,600 at
// Kp = 40, against 3 Kp^2 floats of traffic for the whole solve, so by
// the card's peaks the operations bind (0.0071 ms for the chol fit's
// 128 x 40 x 40). The kernel is bound instead by the latency of its
// dependency chain: sweeps x (Kp-1) steps, each needing the whole of the
// step before it. A step is at least a barrier, the loads of A_pp, A_qq,
// A_pq, the rotation chain (three __fdiv_rn and two __fsqrt_rn in a row,
// ~360 cycles on its own) and the block updates after it.
//
// Design. The first form of this kernel (one 8-warp CTA a matrix, A and V
// in shared memory) took 0.486 ms at 128 x 40 x 40, ~1.8 us a step. It
// lost time in five places, each answered here:
//   1. three barrier phases a step (rotations; columns of A and V; rows
//      of A): here one. A lives in two shared buffers used in turn, a
//      step reading one and writing the other, so no thread writes what
//      another of the same step still reads;
//   2. a serial rotation phase, Kp/2 of 256 threads busy while the rest
//      waited at a barrier: every A warp computes all Kp/2 rotations
//      itself, lane j the pair j, with the same intrinsics in the same
//      order (every warp gets the same bits), and hands them to its lanes
//      by warp shuffles;
//   3. a runtime Kp and integer divisions by it in every index: Kp is a
//      template parameter, every even Kp from 2 to 64 instantiated and
//      chosen by the C entry point (no runtime-Kp fallback);
//   4. A read and written twice a step: each (row pair k, column pair l)
//      2x2 block of A is one lane's, which applies pair l's column
//      rotation to its two rows, then pair k's row rotation to its two
//      new columns, in registers: the same operations in the same order
//      as the two passes, one read and one write of A a step. A is held
//      by tournament position and folded, so a step reads the same places
//      every time, a block's rows as two float2s;
//   5. mostly idle warps, and V on the critical path: 4 A warps share the
//      blocks (lane groups of Kp/2 lanes, 32/(Kp/2) a warp, taking row
//      pairs in turn); V moves to warps of its own, a lane a row of V in
//      registers by position, a sweep behind A, from the c and s that A's
//      warp 0 leaves in shared memory. V then costs A no shared-memory
//      traffic and no barrier, and only the last sweep's V is left after
//      A is done.
// Measured on the H100 (tools/port_probes.py jacobi; NVIDIA H100 80GB
// HBM3, 700 W): 0.136 ms at 128 x 40 x 40 (7 sweeps, 0.50 us a step),
// 0.206 ms at 256 x 40 x 40; with 2 or 8 A warps 11 % and 3 % slower.
// One-off builds with in-kernel clocks found ~510 cycles of a Kp = 40
// step up to c and s (its loads issued, the chain) and ~390 after them,
// and an approximate rotation chain only 3 % faster (PERF.md).
// Before each sweep a block reduction of the off-diagonal square-sum, in
// float64 (__dmul_rn, __dadd_rn) and in a fixed order, is held against
// the matrix's own tolerance; each matrix stops on its own (the JAX loop
// rotates all until all have converged). Shared memory: two A buffers,
// two sweeps' c and s, 64 KB at Kp = 64, so it is dynamic.

#include <cuda_runtime.h>

// warps a matrix that rotate A, at most as many as the row pairs give work
// to (tools/port_probes.py jacobi times other counts)
#ifndef JACOBI_WARPS
#define JACOBI_WARPS 4
#endif

namespace {

constexpr int KMAX = 64;  // largest padded size
constexpr float SMALL = 1e-30f;
constexpr double REL_TOL = 5e-14;
constexpr unsigned FULL = 0xffffffffu;

// The launch plan of one Kp.
template <int KP>
struct Plan {
  static constexpr int H = KP / 2;   // pairs a step
  static constexpr int M = KP - 1;   // steps a sweep
  static constexpr int LD = KP;      // row pitch of A (folded, below)
  static constexpr int G = 32 / H;   // lane groups an A warp, H lanes each
  static constexpr int NW_MAX = (H + G - 1) / G;  // warps with a row pair
  static constexpr int NW_A = NW_MAX < JACOBI_WARPS ? NW_MAX : JACOBI_WARPS;
  static constexpr int NW_V = (KP + 31) / 32;  // a lane a row of V
  static constexpr int NT_A = NW_A * 32;
  static constexpr int NT = (NW_A + NW_V) * 32;
  static constexpr int RED = 32 * sizeof(double);  // block_sum's slots
  static constexpr int MAT = KP * LD * sizeof(float);
  static constexpr int TRASH = 32 * sizeof(float);
  static constexpr int CS = 2 * M * H * sizeof(float2);  // two sweeps' c, s
  static constexpr int SMEM = RED + 2 * MAT + TRASH + CS;
};

// The round-robin tournament of ../jacobi.py:_round_robin_pairs, by
// position (tests/test_torch_jacobi.py holds it to the table): the Kp
// players stand at positions 0 .. Kp-1, at step 0 player i at position i;
// pair j of a step is the players at positions j and Kp-1-j, the first
// taking the sign +1; between steps the players at positions 1 .. Kp-1
// move on by one (Kp-1 to 1), which brings each back after the Kp-1
// steps of a sweep. A is held by position, folded so that each pair's
// two positions are neighbours: position j < Kp/2 at index 2j, Kp-1-j at
// 2j+1. So a step reads the same places every time, pair j's 2x2 blocks
// as float2s, and writes each element where its players stand next.
template <int KP>
__device__ __forceinline__ int fold(int pos) {
  return pos < KP / 2 ? 2 * pos : 2 * (KP - 1 - pos) + 1;
}

// The folded index that the element at folded index f moves to.
template <int KP>
__device__ __forceinline__ int moved(int f) {
  const int pos = f % 2 ? KP - 1 - f / 2 : f / 2;
  return fold<KP>(pos == 0 ? 0 : pos == KP - 1 ? 1 : pos + 1);
}

// Sum of v over the block, in a fixed order; every thread gets it.
template <int NW>
__device__ __forceinline__ double block_sum(double v, double* red) {
  for (int o = 16; o > 0; o >>= 1) {
    v = __dadd_rn(v, __shfl_down_sync(FULL, v, o));
  }
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  double t = 0.0;
  for (int i = 0; i < NW; ++i) t = __dadd_rn(t, red[i]);
  __syncthreads();  // red is written again by the next sum
  return t;
}

// Rotation of one pair from A_pp, A_qq, A_pq, without a branch.
__device__ __forceinline__ void rotation(float app, float aqq, float apq,
                                         float& c, float& s) {
  const bool small = fabsf(apq) < SMALL;
  const float tau =
      __fdiv_rn(__fsub_rn(aqq, app), __fmul_rn(2.f, small ? 1.f : apq));
  const float r = __fsqrt_rn(__fadd_rn(1.f, __fmul_rn(tau, tau)));
  float t = __fdiv_rn(tau < 0.f ? -1.f : 1.f, __fadd_rn(fabsf(tau), r));
  t = small ? 0.f : t;
  c = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(1.f, __fmul_rn(t, t))));
  s = __fmul_rn(t, c);
}

__device__ __forceinline__ float rot_lo(float c, float s, float x, float y) {
  return __fsub_rn(__fmul_rn(c, x), __fmul_rn(s, y));  // c x - s y
}

__device__ __forceinline__ float rot_hi(float c, float s, float x, float y) {
  return __fadd_rn(__fmul_rn(c, y), __fmul_rn(s, x));  // c y + s x
}

// The A warps' barrier (named barrier 1; the V warps go on).
template <int NT_A>
__device__ __forceinline__ void a_barrier() {
  if constexpr (NT_A == 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync 1, %0;" ::"r"(NT_A) : "memory");
  }
}

// One sweep of A by the A warps: Kp-1 steps, each reading A (folded)
// from one buffer (rd) and writing it to the other where its players
// stand next, with one barrier a step. Warp 0's lanes l < H leave each
// step's c and s of pair l in cs.
template <int KP>
__device__ __forceinline__ void a_sweep(float* rd, float* wr, float* trash,
                                        float2* cs) {
  using P = Plan<KP>;
  constexpr int H = P::H, M = P::M, LD = P::LD, G = P::G;
  constexpr int NG = P::NW_A * G;        // lane groups
  constexpr int NA = (H + NG - 1) / NG;  // blocks of A a lane
  const int lane = threadIdx.x % 32;
  const int l = lane % H;                           // the lane's pair
  const int grp = threadIdx.x / 32 * G + lane / H;  // the lane's group
  const bool active = lane < G * H;
  // the same places every step: the lane's columns 2l, 2l+1 and the rows
  // 2k, 2k+1 of its blocks (row pair k, column pair l), k = grp + n NG,
  // and where they move
  const int cp = moved<KP>(2 * l), cq = moved<KP>(2 * l + 1);
  bool mine[NA];
  int src[NA], at[NA];  // the lane holding pair k's c and s; row 2k, col 2l
  int dp[NA], dq[NA];   // where rows 2k, 2k+1 move
#pragma unroll
  for (int n = 0; n < NA; ++n) {
    const int k = grp + n * NG;
    mine[n] = active && k < H;
    src[n] = mine[n] ? k : 0;
    at[n] = 2 * src[n] * LD + 2 * l;
    dp[n] = moved<KP>(2 * src[n]) * LD;
    dq[n] = moved<KP>(2 * src[n] + 1) * LD;
  }
  for (int t = 0; t < M; ++t) {
    // Every load of the step first, then the rotation chain, then the
    // stores: no store sits between two loads (the compiler cannot tell
    // rd and wr apart and would keep them in order), and no branch: a
    // lane without a block stores to its trash slot.
    const float2 d = *reinterpret_cast<const float2*>(rd + 2 * l * LD +
                                                      2 * l);  // A_pp, A_pq
    const float aqq = rd[(2 * l + 1) * LD + 2 * l + 1];
    float2 xy1[NA], xy2[NA];  // rows 2k, 2k+1 at columns 2l, 2l+1
#pragma unroll
    for (int n = 0; n < NA; ++n) {
      xy1[n] = *reinterpret_cast<const float2*>(rd + at[n]);
      xy2[n] = *reinterpret_cast<const float2*>(rd + at[n] + LD);
    }
    float c, s;
    rotation(d.x, aqq, d.y, c, s);
    if (threadIdx.x < H) cs[t * H + l] = make_float2(c, s);
#pragma unroll
    for (int n = 0; n < NA; ++n) {
      const float ck = __shfl_sync(FULL, c, src[n]);
      const float sk = __shfl_sync(FULL, s, src[n]);
      // columns p, q (pair l) of rows pk, qk
      const float a1 = rot_lo(c, s, xy1[n].x, xy1[n].y);
      const float b1 = rot_hi(c, s, xy1[n].x, xy1[n].y);
      const float a2 = rot_lo(c, s, xy2[n].x, xy2[n].y);
      const float b2 = rot_hi(c, s, xy2[n].x, xy2[n].y);
      // then rows pk, qk (pair k) of columns p, q, where they move
      float* to_p = mine[n] ? wr + dp[n] : trash;
      float* to_q = mine[n] ? wr + dq[n] : trash;
      const int jp = mine[n] ? cp : lane, jq = mine[n] ? cq : lane;
      to_p[jp] = rot_lo(ck, sk, a1, a2);
      to_q[jp] = rot_hi(ck, sk, a1, a2);
      to_p[jq] = rot_lo(ck, sk, b1, b2);
      to_q[jq] = rot_hi(ck, sk, b1, b2);
    }
    a_barrier<P::NT_A>();
    float* done = wr;  // the buffers trade places
    wr = rd;
    rd = done;
  }
}

// One sweep's rotations of a row of V, held in registers by position in
// the tournament (v[pos] = V(i, the player at pos)): pair j is v[j] and
// v[Kp-1-j] at every step, and between steps the players at positions
// 1 .. Kp-1 move on by one, which returns them to their places after the
// Kp-1 steps of a sweep. c and s come from the A warps, through cs.
template <int KP>
__device__ __forceinline__ void v_sweep(float (&v)[KP], const float2* cs) {
  constexpr int H = KP / 2, M = KP - 1;
#pragma unroll 1
  for (int t = 0; t < M; ++t) {
#pragma unroll
    for (int j = 0; j < H; ++j) {
      const float2 r = cs[t * H + j];  // the same address for every lane
      const float x = v[j], y = v[KP - 1 - j];
      v[j] = rot_lo(r.x, r.y, x, y);
      v[KP - 1 - j] = rot_hi(r.x, r.y, x, y);
    }
    const float last = v[KP - 1];
#pragma unroll
    for (int pos = KP - 1; pos > 1; --pos) v[pos] = v[pos - 1];
    v[1] = last;
  }
}

// Before each sweep, every thread of the block: true while A is above
// its tolerance (the float64 off-diagonal square-sum, in a fixed order).
template <int KP>
__device__ __forceinline__ bool go_on(const float* cur, double tol,
                                      double* red) {
  using P = Plan<KP>;
  __syncthreads();  // the last sweep's A and c, s published
  double off = 0.0;
  for (int e = threadIdx.x; e < KP * KP; e += P::NT) {
    const int i = e / KP, j = e % KP;
    if (i != j) {
      const double x = cur[i * P::LD + j];
      off = __dadd_rn(off, __dmul_rn(x, x));
    }
  }
  return block_sum<P::NT / 32>(off, red) > tol;
}

// The A warps and the V warps each run the sweep loop in their own branch
// (so that V's registers are not live in A's), through the same block
// barriers in the same order.
template <int KP>
__global__ void __launch_bounds__(Plan<KP>::NT)
    jacobi_kernel(const float* __restrict__ A, float* __restrict__ w,
                  float* __restrict__ V, int* __restrict__ n_sweeps,
                  int sweeps) {
  using P = Plan<KP>;
  constexpr int H = P::H, M = P::M, LD = P::LD, NT = P::NT, N = KP * KP;
  extern __shared__ __align__(16) unsigned char smem[];
  double* red = reinterpret_cast<double*>(smem);
  float* bufs = reinterpret_cast<float*>(smem + P::RED);  // A, twice
  float* trash = bufs + 2 * KP * LD;  // a slot a lane for idle lanes' stores
  float2* cs = reinterpret_cast<float2*>(trash + 32);  // by sweep parity

  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  const float* Ab = A + b * N;

  double sq = 0.0;
  for (int e = tid; e < N; e += NT) {
    const float a = Ab[e];
    bufs[fold<KP>(e / KP) * LD + fold<KP>(e % KP)] = a;
    sq = __dadd_rn(sq, __dmul_rn(a, a));
  }
  // (block_sum's barriers publish A)
  const double tol = fmax(block_sum<NT / 32>(sq, red), 1e-30) * REL_TOL;
  // A as a sweep finds it (folded; its players back at their positions):
  // Kp-1 is odd, so the buffers swap each sweep
  auto a_of = [&](int sweep) { return bufs + (sweep & 1) * KP * LD; };

  int sweep = 0;
  if (tid < P::NT_A) {
    for (; sweep < sweeps && go_on<KP>(a_of(sweep), tol, red); ++sweep) {
      a_sweep<KP>(a_of(sweep), a_of(sweep + 1), trash,
                  cs + (sweep & 1) * M * H);
    }
    __syncthreads();
    const float* cur = a_of(sweep);
    for (int i = tid; i < KP; i += P::NT_A) {
      w[b * KP + i] = cur[fold<KP>(i) * (LD + 1)];
    }
    if (tid == 0) n_sweeps[b] = sweep;
  } else {
    const int row = tid - P::NT_A;  // the lane's row of V
    float v[KP];                    // by position; V = I
#pragma unroll
    for (int pos = 0; pos < KP; ++pos) v[pos] = pos == row ? 1.f : 0.f;
    const bool mine = row < KP;
    for (; sweep < sweeps && go_on<KP>(a_of(sweep), tol, red); ++sweep) {
      if (sweep > 0 && mine) {  // a sweep behind A
        v_sweep<KP>(v, cs + ((sweep - 1) & 1) * M * H);
      }
    }
    __syncthreads();
    if (sweep > 0 && mine) v_sweep<KP>(v, cs + ((sweep - 1) & 1) * M * H);
    if (mine) {
      float* Vr = V + b * N + row * KP;
#pragma unroll
      for (int pos = 0; pos < KP; ++pos) Vr[pos] = v[pos];
    }
  }
}

template <int KP>
int launch(const float* A, float* w, float* V, int* n_sweeps, int B,
           int sweeps, cudaStream_t stream) {
  using P = Plan<KP>;
  if (P::SMEM > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        jacobi_kernel<KP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        P::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  jacobi_kernel<KP><<<B, P::NT, P::SMEM, stream>>>(A, w, V, n_sweeps, sweeps);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation of Kp: every even Kp from K to KMAX.
template <int K>
int dispatch(int Kp, const float* A, float* w, float* V, int* n_sweeps,
             int B, int sweeps, cudaStream_t stream) {
  if (Kp == K) return launch<K>(A, w, V, n_sweeps, B, sweeps, stream);
  if constexpr (K < KMAX) {
    return dispatch<K + 2>(Kp, A, w, V, n_sweeps, B, sweeps, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// A (B, Kp, Kp) float32 contiguous, symmetric, Kp even in [2, 64]; w
// (B, Kp), V (B, Kp, Kp) float32 and n_sweeps (B,) int32 are written.
// Returns the launch's cudaError_t.
int jacobi_eigh_f32(const void* A, void* w, void* V, void* n_sweeps, int B,
                    int Kp, int sweeps, void* stream) {
  if (B < 1 || Kp < 2 || Kp > KMAX || (Kp & 1) || sweeps < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch<2>(Kp, static_cast<const float*>(A), static_cast<float*>(w),
                     static_cast<float*>(V), static_cast<int*>(n_sweeps), B,
                     sweeps, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
