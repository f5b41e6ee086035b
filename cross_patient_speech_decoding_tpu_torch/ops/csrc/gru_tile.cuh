// The tiled float32 SIMT product of one GRU step's gate pre-activations,
// run by the bidirectional forward's step kernel (gru_fwd.cu); its
// sigmoid_f32 serves every GRU kernel.
//
// A CTA owns a (TB x TH) block of the step's output: TB batch rows, and TH
// hidden columns of each of the three gates. gate_products computes, for
// those columns, x_t Wi and h_{t-1} Wh from KT-deep shared-memory tiles of
// x or h and of the three gate column slices of Wi or Wh: one loop runs
// over the F input tiles, then the H recurrent ones, with the next tile's
// global loads staged in registers while the current tile is multiplied.
// Row b of a step's input is F contiguous values at x + b*sx_b.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TB = 64;   // batch rows per CTA
constexpr int TH = 32;   // hidden columns per CTA (per gate)
constexpr int KT = 16;   // reduction depth per shared-memory tile
constexpr int NT = 256;  // threads per CTA
constexpr int RPT = TB / (NT / TH);  // batch rows per thread (8)
// A tile row length: 4 floats of padding keep rows 16-byte aligned for
// the float4 reads and cut the transposing stores from 16-way to 2-way
// bank conflicts
constexpr int AP = TB + 4;
constexpr int A_PER_T = TB * KT / NT;       // A elements a thread stages
constexpr int W_PER_T = 3 * KT * TH / NT;   // weight elements a thread stages

static_assert(RPT == 8, "each thread owns 8 rows of one column");
static_assert((TB * KT) % NT == 0, "A tile load must divide evenly");
static_assert((3 * KT * TH) % NT == 0, "W tile load must divide evenly");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float sigmoid_f32(float v) {
  return 1.0f / (1.0f + expf(-v));
}

struct Tiles {
  float a[2][KT][AP];      // x or h_{t-1}: [k][batch row], double buffered
  float w[2][3][KT][TH];   // Wi or Wh: [gate][k][hidden column]
};

// Reduction tile `it` of a step: tiles [0, nx) run over the F inputs
// (x_t Wi), tiles [nx, nx + nh) over the H recurrent inputs (h_{t-1} Wh).
// Loads the tile's A block (TB rows x KT) and the three gate slices of
// its weight rows into registers; out-of-range elements are 0.
template <typename T>
__device__ __forceinline__ void fetch_tile(
    int it, int nx, const T* __restrict__ x, long long sx_b,
    const float* __restrict__ hprev, const float* __restrict__ wi,
    const float* __restrict__ wh, int b0, int j0, int B, int F, int H,
    float (&ra)[A_PER_T], float (&rw)[W_PER_T]) {
  const bool is_x = it < nx;
  const int k0 = (is_x ? it : it - nx) * KT;
#pragma unroll
  for (int i = 0; i < A_PER_T; ++i) {
    const int e = threadIdx.x + i * NT;
    const int b = b0 + e / KT;
    const int k = k0 + e % KT;
    float v = 0.0f;
    if (is_x) {
      if (b < B && k < F) v = to_f32(x[b * sx_b + k]);
    } else if (b < B && k < H) {
      v = hprev[static_cast<long long>(b) * H + k];
    }
    ra[i] = v;
  }
  const float* __restrict__ w = is_x ? wi : wh;
  const int K = is_x ? F : H;
#pragma unroll
  for (int i = 0; i < W_PER_T; ++i) {
    const int e = threadIdx.x + i * NT;
    const int g = e / (KT * TH);
    const int rem = e % (KT * TH);
    const int k = k0 + rem / TH;
    const int j = j0 + rem % TH;
    rw[i] = (k < K && j < H)
                ? w[static_cast<long long>(k) * 3 * H + g * H + j]
                : 0.0f;
  }
}

__device__ __forceinline__ void store_tile(Tiles& s, int buf,
                                           const float (&ra)[A_PER_T],
                                           const float (&rw)[W_PER_T]) {
#pragma unroll
  for (int i = 0; i < A_PER_T; ++i) {
    const int e = threadIdx.x + i * NT;
    s.a[buf][e % KT][e / KT] = ra[i];
  }
#pragma unroll
  for (int i = 0; i < W_PER_T; ++i) {
    const int e = threadIdx.x + i * NT;
    const int rem = e % (KT * TH);
    s.w[buf][e / (KT * TH)][rem / TH][rem % TH] = rw[i];
  }
}

// acc_g[i] += sum_k A[k][row_i] * W[g][k][col] for the three gates.
__device__ __forceinline__ void mma_tile(const float (*A)[AP],
                                         const float (*W)[KT][TH], int ty,
                                         int tx, float* acc_r, float* acc_z,
                                         float* acc_n) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(&A[kk][ty * RPT]);
    const float4 a1 = *reinterpret_cast<const float4*>(&A[kk][ty * RPT + 4]);
    const float a[RPT] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float wr = W[0][kk][tx];
    const float wz = W[1][kk][tx];
    const float wn = W[2][kk][tx];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      acc_r[i] = fmaf(a[i], wr, acc_r[i]);
      acc_z[i] = fmaf(a[i], wz, acc_z[i]);
      acc_n[i] = fmaf(a[i], wn, acc_n[i]);
    }
  }
}

// The gate pre-activations of this CTA's block, without biases: thread
// (ty, tx) = (threadIdx.x / TH, threadIdx.x % TH) gets, for hidden column
// blockIdx.x*TH + tx and batch rows blockIdx.y*TB + ty*RPT + i,
//   acc_r[i], acc_z[i]: (x_t Wi + h_{t-1} Wh) of gates r and z,
//   acc_in[i]: x_t Wi_n,   acc_hn[i]: h_{t-1} Wh_n (which r scales).
// x points at this step's row of batch 0.
template <typename T>
__device__ __forceinline__ void gate_products(
    Tiles& s, const T* __restrict__ x, long long sx_b,
    const float* __restrict__ hprev, const float* __restrict__ wi,
    const float* __restrict__ wh, int B, int F, int H, float (&acc_r)[RPT],
    float (&acc_z)[RPT], float (&acc_in)[RPT], float (&acc_hn)[RPT]) {
  const int tx = threadIdx.x % TH;
  const int ty = threadIdx.x / TH;
  const int b0 = blockIdx.y * TB;
  const int j0 = blockIdx.x * TH;
  const int nx = (F + KT - 1) / KT;
  const int n_tiles = nx + (H + KT - 1) / KT;

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    acc_r[i] = 0.0f;
    acc_z[i] = 0.0f;
    acc_in[i] = 0.0f;
    acc_hn[i] = 0.0f;
  }

  // Register-staged double buffering: the global loads of tile it + 1
  // are in flight while tile it is multiplied out of shared memory; one
  // barrier per tile.
  float ra[A_PER_T], rw[W_PER_T];
  fetch_tile<T>(0, nx, x, sx_b, hprev, wi, wh, b0, j0, B, F, H, ra, rw);
  store_tile(s, 0, ra, rw);
  __syncthreads();
  for (int it = 0; it < n_tiles; ++it) {
    const int cur = it & 1;
    const bool more = it + 1 < n_tiles;
    if (more) {
      fetch_tile<T>(it + 1, nx, x, sx_b, hprev, wi, wh, b0, j0, B, F, H, ra,
                    rw);
    }
    // x_t Wi feeds r, z and the input half of n; h_{t-1} Wh feeds r, z
    // and the recurrent half of n, which r scales
    if (it < nx) {
      mma_tile(s.a[cur], s.w[cur], ty, tx, acc_r, acc_z, acc_in);
    } else {
      mma_tile(s.a[cur], s.w[cur], ty, tx, acc_r, acc_z, acc_hn);
    }
    if (more) store_tile(s, cur ^ 1, ra, rw);
    __syncthreads();
  }
}

}  // namespace
