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
// the tests hold it against): for each (Kp, Kp) matrix, Kp even <= 64,
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
// the JAX package's tournament, passed in as a (Kp-1, Kp/2, 2) int table,
// so that the rotations and their order are those of the plain version.
// Every rotation is rounded op by op (__fmul_rn, __fsub_rn, ...), so no
// FMA contraction separates it from the plain version's tensor ops.
//
// Design. One CTA per matrix, and the whole solve, up to `sweeps` sweeps,
// in one launch: A and V live in shared memory (2 x 64 x 65 floats, one
// column of row padding so that a column walk hits 32 banks), the
// schedule beside them as bytes. A step is three phases separated by
// __syncthreads(): one warp computes c and s of the Kp/2 pairs from
// A_pp, A_qq, A_pq; the block rotates columns p, q of A and V; then rows
// p, q of A. Direct Givens updates cost O(Kp^2) a step where the TPU's
// permutation products cost O(Kp^3), and need no bf16 split. Before each
// sweep a block reduction of the masked off-diagonal square-sum, in
// float64 and in a fixed order, is held against the matrix's own
// tolerance; each matrix stops on its own (the JAX loop rotates all until
// all have converged).
//
// What bounds it. Per sweep a matrix needs 9 Kp^2 (Kp-1) FLOPs (Kp-1
// steps x Kp/2 pairs x 3 vector pairs x Kp elements x 6), 561,600 at
// Kp = 40, against 3 Kp^2 floats of traffic for the whole solve: by the
// card's peaks the operations bind. As written, the kernel is held back
// by latency instead: 3 (Kp-1) dependent barrier phases a sweep, each
// with a few shared-memory operations per thread, and one CTA of 256
// threads per matrix, so that a batch of 128-256 matrices fills the card
// thinly. Faster forms, for later work: a warp per matrix with A in
// registers for Kp <= 32, several matrices per CTA, fewer barriers.

#include <cuda_runtime.h>

namespace {

constexpr int KMAX = 64;      // largest padded size
constexpr int LD = KMAX + 1;  // row pitch of A and V in shared memory
constexpr int NT = 256;       // threads per CTA
constexpr int NWARP = NT / 32;
constexpr float SMALL = 1e-30f;
constexpr double REL_TOL = 5e-14;

// Sum of v over the block, in a fixed order; every thread gets it.
__device__ __forceinline__ double block_sum(double v, double* red,
                                           double* out) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    double t = 0.0;
    for (int i = 0; i < NWARP; ++i) t += red[i];
    *out = t;
  }
  __syncthreads();
  return *out;
}

// Rotation of one pair from A_pp, A_qq, A_pq.
__device__ __forceinline__ void rotation(float app, float aqq, float apq,
                                         float& c, float& s) {
  if (fabsf(apq) < SMALL) {
    c = 1.f;
    s = 0.f;
    return;
  }
  const float tau = __fdiv_rn(__fsub_rn(aqq, app), __fmul_rn(2.f, apq));
  const float r = __fsqrt_rn(__fadd_rn(1.f, __fmul_rn(tau, tau)));
  const float t = __fdiv_rn(tau < 0.f ? -1.f : 1.f, __fadd_rn(fabsf(tau), r));
  c = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(1.f, __fmul_rn(t, t))));
  s = __fmul_rn(t, c);
}

// (x, y) <- (c x - s y, c y + s x)
__device__ __forceinline__ void rotate(float* x, float* y, float c, float s) {
  const float a = *x, b = *y;
  *x = __fsub_rn(__fmul_rn(c, a), __fmul_rn(s, b));
  *y = __fadd_rn(__fmul_rn(c, b), __fmul_rn(s, a));
}

__global__ void __launch_bounds__(NT)
    jacobi_kernel(const float* __restrict__ A, const int* __restrict__ pairs,
                  float* __restrict__ w, float* __restrict__ V,
                  int* __restrict__ n_sweeps, int Kp, int sweeps) {
  __shared__ float sA[KMAX * LD];
  __shared__ float sV[KMAX * LD];
  __shared__ unsigned char sched[(KMAX - 1) * KMAX];
  __shared__ float rc[KMAX / 2], rs[KMAX / 2];
  __shared__ int rp[KMAX / 2], rq[KMAX / 2];
  __shared__ double red[NWARP];
  __shared__ double total;

  const int tid = threadIdx.x;
  const int n = Kp * Kp;
  const int half = Kp / 2;
  const size_t b = blockIdx.x;
  const float* Ab = A + b * n;

  double sq = 0.0;
  for (int e = tid; e < n; e += NT) {
    const int i = e / Kp, j = e - i * Kp;
    const float a = Ab[e];
    sA[i * LD + j] = a;
    sV[i * LD + j] = i == j ? 1.f : 0.f;
    sq += (double)a * (double)a;
  }
  for (int e = tid; e < (Kp - 1) * Kp; e += NT) {
    sched[e] = static_cast<unsigned char>(pairs[e]);
  }
  // (block_sum's barriers also publish sA, sV and sched)
  const double tol = fmax(block_sum(sq, red, &total), 1e-30) * REL_TOL;

  int sweep = 0;
  for (; sweep < sweeps; ++sweep) {
    double off = 0.0;
    for (int e = tid; e < n; e += NT) {
      const int i = e / Kp, j = e - i * Kp;
      if (i != j) {
        const double x = sA[i * LD + j];
        off += x * x;
      }
    }
    if (!(block_sum(off, red, &total) > tol)) break;  // uniform

    for (int t = 0; t < Kp - 1; ++t) {
      if (tid < half) {
        const int p = sched[(t * half + tid) * 2];
        const int q = sched[(t * half + tid) * 2 + 1];
        float c, s;
        rotation(sA[p * LD + p], sA[q * LD + q], sA[p * LD + q], c, s);
        rp[tid] = p;
        rq[tid] = q;
        rc[tid] = c;
        rs[tid] = s;
      }
      __syncthreads();
      // columns p, q of A, then of V: neighbouring threads walk down a
      // column (banks (i + p) mod 32 with the odd pitch)
      for (int e = tid; e < 2 * half * Kp; e += NT) {
        const bool onV = e >= half * Kp;
        const int e2 = onV ? e - half * Kp : e;
        const int k = e2 / Kp, i = e2 - k * Kp;
        float* row = (onV ? sV : sA) + i * LD;
        rotate(row + rp[k], row + rq[k], rc[k], rs[k]);
      }
      __syncthreads();
      // rows p, q of A: neighbouring threads read neighbouring words
      for (int e = tid; e < half * Kp; e += NT) {
        const int k = e / Kp, j = e - k * Kp;
        rotate(sA + rp[k] * LD + j, sA + rq[k] * LD + j, rc[k], rs[k]);
      }
      __syncthreads();
    }
  }

  float* Vb = V + b * n;
  for (int e = tid; e < n; e += NT) {
    const int i = e / Kp, j = e - i * Kp;
    Vb[e] = sV[i * LD + j];
  }
  for (int i = tid; i < Kp; i += NT) w[b * Kp + i] = sA[i * LD + i];
  if (tid == 0) n_sweeps[b] = sweep;
}

}  // namespace

extern "C" {

// A (B, Kp, Kp) float32 contiguous, symmetric, Kp even in [2, 64];
// pairs (Kp-1, Kp/2, 2) int32; w (B, Kp), V (B, Kp, Kp) float32 and
// n_sweeps (B,) int32 are written. Returns the launch's cudaError_t.
int jacobi_eigh_f32(const void* A, const void* pairs, void* w, void* V,
                    void* n_sweeps, int B, int Kp, int sweeps, void* stream) {
  if (B < 1 || Kp < 2 || Kp > KMAX || (Kp & 1) || sweeps < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  jacobi_kernel<<<B, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(A), static_cast<const int*>(pairs),
      static_cast<float*>(w), static_cast<float*>(V),
      static_cast<int*>(n_sweeps), Kp, sweeps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
