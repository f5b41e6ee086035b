// GRU layer backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the two backward Pallas kernels of
// cross_patient_speech_decoding_tpu/ops/pallas_gru.py:
//   - _bwd_kernel  (launched by _gru_backward, VJP of gru_layer): the
//     backward of a GRU over a time-major (T, B, F) input, forward or
//     reversed in time; dx = dgi Wi^T when need_dx is set;
//   - _wbwd_kernel (launched by _gru_win_backward, VJP of
//     gru_layer_windowed): the backward of the layer-0 GRU over overlapping
//     windows of the raw frames; no input gradient.
// Both emit dh0, dWi, dWh and the two biases' gradients, summed over batch
// and time with the per-step accumulate of _accum_dw (pallas_gru.py:536-541)
// as the contract.
//
// Math of one step at time t (pallas_gru.py:602-633), the gates recomputed
// from (x_t, h_{t-1}) as in the forward (gru_tile.cuh), ghn = h_{t-1} Wh_n
// + bh_n, dh the gradient carried from the later step:
//   d   = dh + dhs[t]
//   dz  = d (h_{t-1} - n) z (1 - z),   dn = d (1 - z)(1 - n^2)
//   dr  = dn ghn r (1 - r),            dgn = dn r
//   dgi = [dr, dz, dn]  (gradient of x Wi + bi)
//   dgh = [dr, dz, dgn] (gradient of h Wh + bh)
//   dh' = d z + dgh Wh^T,   dx[t] = dgi Wi^T
//   dWi += x_t^T dgi,  dWh += h_{t-1}^T dgh,  dbi += sum_b dgi,  dbh += ...
//
// Design. The TPU kernel carries dh, dWi, dWh and db in VMEM across a grid
// that runs in order. Blocks on Hopper run in no order and share nothing,
// so the work is split by what depends on what:
//   1. The dh recurrence, one step at a time from the host loop below (the
//      launch boundary is the grid-wide barrier), two grids a step:
//      gate_grad_kernel recomputes the gates for a (TB x TH) block exactly as
//      the forward does (gate_products), forms dr, dz, dn and dgn in
//      registers, and writes them to a scratch stream g (T, B, 4H) beside
//      d*z (B, H); then rowmm_kernel forms dh' = d z + dgh Wh^T over the
//      whole row (dgh needs every column of the step). The gates are not
//      stored by the forward: recomputing them is what the TPU kernel does.
//   2. After the sweep, everything that is off the recurrence reads the
//      gate-gradient stream g as a whole: dx = dgi Wi^T over all T*B rows
//      (rowmm_kernel again), and dWi, dWh with their biases as one
//      reduction each over all (t, b) rows (wgrad_kernel). A ones column
//      appended to x (and to h_{t-1}) makes the bias gradient the last row
//      of the same product. The t*b axis is split over CTAs into a fixed
//      number of partial sums, which sum_parts_kernel adds in a fixed
//      order: no float atomics, so two runs give the same gradients.
// For the windowed kernel the x rows of the gate recompute and of the dWi
// sum are the window rows of the batch-major frames, read in place as the
// forward reads them: the (n_win, B, win*C) window stream is never built.
//
// What bounds it. Per step and layer the work is 2*B*3H*(3F + 3H) FLOPs
// (recompute, dh Wh^T, dx, dWi, dWh; 2F + 3H without dx) against
// O(B*(F + H) + (F + H)*3H) inputs, far above the card's operations-per-
// byte line: bound by operations. As written every product runs in float32
// on the SIMT units (67 TFLOP/s peak), which keeps the gradients within
// float32 roundoff of the plain version. The g stream costs 16*B*H bytes a
// step (2.4 GB a layer at fig_5 width, freed by the caller after the layer)
// and is read back twice, a small share of the time beside the products.
// Faster forms, for later work: tensor cores (split-TF32 or bf16 wgmma) for
// the large dx and dW products, and a persistent kernel that keeps Wh on
// chip across steps.

#include "gru_tile.cuh"

namespace {

// Gate recompute and gate gradients of one step for the CTA's (TB x TH)
// block. x, hprev and dhs point at this step's rows; dh is the gradient
// carried from the later step (zero at the first step of the sweep). Writes
// g row b = [dr | dz | dn | dgn] (4H values) and dhz = d * z.
template <typename T>
__global__ void __launch_bounds__(NT, 2)
    gate_grad_kernel(const T* __restrict__ x, long long sx_b,
                     const float* __restrict__ hprev,
                     const float* __restrict__ dhs,
                     const float* __restrict__ dh,
                     const float* __restrict__ wi, const float* __restrict__ bi,
                     const float* __restrict__ wh, const float* __restrict__ bh,
                     float* __restrict__ g, float* __restrict__ dhz, int B,
                     int F, int H) {
  __shared__ __align__(16) Tiles s;
  float acc_r[RPT], acc_z[RPT], acc_in[RPT], acc_hn[RPT];
  gate_products<T>(s, x, sx_b, hprev, wi, wh, B, F, H, acc_r, acc_z, acc_in,
                   acc_hn);

  const int tx = threadIdx.x % TH;
  const int ty = threadIdx.x / TH;
  const int b0 = blockIdx.y * TB;
  const int j = blockIdx.x * TH + tx;
  if (j >= H) return;
  const float br = bi[j] + bh[j];
  const float bz = bi[H + j] + bh[H + j];
  const float bin = bi[2 * H + j];
  const float bhn = bh[2 * H + j];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int b = b0 + ty * RPT + i;
    if (b >= B) break;
    const long long o = static_cast<long long>(b) * H + j;
    const float r = sigmoid_f32(acc_r[i] + br);
    const float z = sigmoid_f32(acc_z[i] + bz);
    const float ghn = acc_hn[i] + bhn;
    const float n = tanhf(acc_in[i] + bin + r * ghn);
    const float d = dh[o] + dhs[o];
    const float dz = d * (hprev[o] - n) * z * (1.0f - z);
    const float dn = d * (1.0f - z) * (1.0f - n * n);
    const float dr = dn * ghn * r * (1.0f - r);
    float* __restrict__ gb = g + static_cast<long long>(b) * 4 * H;
    gb[j] = dr;
    gb[H + j] = dz;
    gb[2 * H + j] = dn;
    gb[3 * H + j] = dn * r;
    dhz[o] = d * z;
  }
}

// ---------------------------------------------------------------------------
// 64 x 64 output tiles, 16 deep, 4 x 4 outputs a thread: the products off
// the gate recompute (dh Wh^T, dx, dW).
// ---------------------------------------------------------------------------

constexpr int MT = 64;      // output tile rows and columns
constexpr int MK = 16;      // reduction depth per tile
constexpr int MP = MT + 4;  // padded tile row (16-byte aligned)
constexpr int M_PER_T = MT * MK / NT;  // operand elements a thread stages

static_assert(M_PER_T == 4, "each thread stages 4 elements of each operand");
static_assert((MT / 4) * (MT / 4) == NT, "4 x 4 outputs per thread");

struct MTiles {
  float a[2][MK][MP];  // [k][output row]
  float b[2][MK][MP];  // [k][output column]
};

__device__ __forceinline__ int gap_col(int k, int gap_at, int gap) {
  return k < gap_at ? k : k + gap;
}

// acc[r][c] += sum_k A[k][ty*4 + r] * Bt[k][tx*4 + c]
__device__ __forceinline__ void mma_4x4(const float (*A)[MP],
                                        const float (*Bt)[MP], int ty, int tx,
                                        float (&acc)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < MK; ++kk) {
    const float4 a4 = *reinterpret_cast<const float4*>(&A[kk][ty * 4]);
    const float4 b4 = *reinterpret_cast<const float4*>(&Bt[kk][tx * 4]);
    const float a[4] = {a4.x, a4.y, a4.z, a4.w};
    const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
  }
}

// Rows [n0, n0 + MT) of a and [i0, i0 + MT) of w, reduction columns
// [k0, k0 + MK): both operands hold k contiguously in a row.
__device__ __forceinline__ void rowmm_fetch(
    const float* __restrict__ a, long long lda, int gap_at, int gap,
    const float* __restrict__ w, long long n0, int i0, int k0, long long N,
    int NO, int K, float (&ra)[M_PER_T], float (&rw)[M_PER_T]) {
#pragma unroll
  for (int i = 0; i < M_PER_T; ++i) {
    const int e = threadIdx.x + i * NT;
    const int row = e / MK;
    const int k = k0 + e % MK;
    const long long n = n0 + row;
    ra[i] = (n < N && k < K) ? a[n * lda + gap_col(k, gap_at, gap)] : 0.0f;
    rw[i] = (i0 + row < NO && k < K)
                ? w[static_cast<long long>(i0 + row) * K + k]
                : 0.0f;
  }
}

__device__ __forceinline__ void rowmm_store(MTiles& s, int buf,
                                            const float (&ra)[M_PER_T],
                                            const float (&rw)[M_PER_T]) {
#pragma unroll
  for (int i = 0; i < M_PER_T; ++i) {
    const int e = threadIdx.x + i * NT;
    s.a[buf][e % MK][e / MK] = ra[i];
    s.b[buf][e % MK][e / MK] = rw[i];
  }
}

// out[n, i] = add[n, i] + sum_{k < K} a[n*lda + gap_col(k)] * w[i*K + k]
// for n < N, i < NO (add may be null). With a = a step's g rows, gap_col
// skipping dn (gap_at 2H, gap H) and w = Wh (H, 3H), this is dh' = d z +
// dgh Wh^T; with no gap and w = Wi (F, 3H) over all rows, dx = dgi Wi^T.
__global__ void __launch_bounds__(NT)
    rowmm_kernel(const float* __restrict__ a, long long lda, int gap_at,
                 int gap, const float* __restrict__ w,
                 const float* __restrict__ add, float* __restrict__ out,
                 long long N, int NO, int K) {
  __shared__ __align__(16) MTiles s;
  const long long n0 = static_cast<long long>(blockIdx.x) * MT;
  const int i0 = blockIdx.y * MT;
  const int ty = threadIdx.x / (MT / 4);
  const int tx = threadIdx.x % (MT / 4);
  const int n_tiles = (K + MK - 1) / MK;

  float acc[4][4] = {};
  float ra[M_PER_T], rw[M_PER_T];
  rowmm_fetch(a, lda, gap_at, gap, w, n0, i0, 0, N, NO, K, ra, rw);
  rowmm_store(s, 0, ra, rw);
  __syncthreads();
  for (int it = 0; it < n_tiles; ++it) {
    const int cur = it & 1;
    const bool more = it + 1 < n_tiles;
    if (more) {
      rowmm_fetch(a, lda, gap_at, gap, w, n0, i0, (it + 1) * MK, N, NO, K, ra,
                  rw);
    }
    mma_4x4(s.a[cur], s.b[cur], ty, tx, acc);
    if (more) rowmm_store(s, cur ^ 1, ra, rw);
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const long long n = n0 + ty * 4 + r;
    if (n >= N) break;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = i0 + tx * 4 + c;
      if (i >= NO) break;
      const long long o = n * NO + i;
      out[o] = add ? add[o] + acc[r][c] : acc[r][c];
    }
  }
}

// Reduction rows (t, b0 .. b0 + MK) of the weight gradient: A(n, m) is row
// (t, b) of x (or h_{t-1}) at a + t*sa_t + b*sa_b, with 1 in column M (the
// bias row) and 0 beyond; G(n, c) is column gap_col(c) of g row t*B + b.
// Rows b >= B are 0.
template <typename T>
__device__ __forceinline__ void wgrad_fetch(
    const T* __restrict__ a, long long sa_t, long long sa_b, int M,
    const float* __restrict__ g, long long ldg, int gap_at, int gap, int NC,
    int t, int b0, int m0, int c0, int B, float (&ra)[M_PER_T],
    float (&rg)[M_PER_T]) {
#pragma unroll
  for (int i = 0; i < M_PER_T; ++i) {
    const int e = threadIdx.x + i * NT;
    const int b = b0 + e / MT;
    const int m = m0 + e % MT;
    const int c = c0 + e % MT;
    float va = 0.0f, vg = 0.0f;
    if (b < B) {
      if (m < M) {
        va = to_f32(a[t * sa_t + b * sa_b + m]);
      } else if (m == M) {
        va = 1.0f;
      }
      if (c < NC) {
        vg = g[(static_cast<long long>(t) * B + b) * ldg +
               gap_col(c, gap_at, gap)];
      }
    }
    ra[i] = va;
    rg[i] = vg;
  }
}

__device__ __forceinline__ void wgrad_store(MTiles& s, int buf,
                                            const float (&ra)[M_PER_T],
                                            const float (&rg)[M_PER_T]) {
#pragma unroll
  for (int i = 0; i < M_PER_T; ++i) {
    const int e = threadIdx.x + i * NT;
    s.a[buf][e / MT][e % MT] = ra[i];
    s.b[buf][e / MT][e % MT] = rg[i];
  }
}

// Partial p = blockIdx.z of the weight gradient:
//   part[p][m][c] = sum over row tiles q in [p*q_per, (p+1)*q_per) of
//                   sum_n A(n, m) G(n, c),   m <= M, c < NC,
// where row tile q is time t = q / nbt, batch rows (q % nbt)*MK .. + MK.
template <typename T>
__global__ void __launch_bounds__(NT)
    wgrad_kernel(const T* __restrict__ a, long long sa_t, long long sa_b,
                 int M, const float* __restrict__ g, long long ldg,
                 int gap_at, int gap, int NC, float* __restrict__ part, int B,
                 long long n_q, long long q_per) {
  __shared__ __align__(16) MTiles s;
  const int m0 = blockIdx.x * MT;
  const int c0 = blockIdx.y * MT;
  const int ty = threadIdx.x / (MT / 4);
  const int tx = threadIdx.x % (MT / 4);
  const int nbt = (B + MK - 1) / MK;
  const long long q0 = blockIdx.z * q_per;
  const long long q1 = q0 + q_per < n_q ? q0 + q_per : n_q;

  float acc[4][4] = {};
  if (q0 < q1) {
    int t = static_cast<int>(q0 / nbt);
    int b0 = static_cast<int>(q0 % nbt) * MK;
    float ra[M_PER_T], rg[M_PER_T];
    wgrad_fetch<T>(a, sa_t, sa_b, M, g, ldg, gap_at, gap, NC, t, b0, m0, c0,
                   B, ra, rg);
    wgrad_store(s, 0, ra, rg);
    __syncthreads();
    for (long long q = q0; q < q1; ++q) {
      const int cur = static_cast<int>((q - q0) & 1);
      const bool more = q + 1 < q1;
      if (more) {
        b0 += MK;
        if (b0 >= B) {
          b0 = 0;
          ++t;
        }
        wgrad_fetch<T>(a, sa_t, sa_b, M, g, ldg, gap_at, gap, NC, t, b0, m0,
                       c0, B, ra, rg);
      }
      mma_4x4(s.a[cur], s.b[cur], ty, tx, acc);
      if (more) wgrad_store(s, cur ^ 1, ra, rg);
      __syncthreads();
    }
  }

  float* __restrict__ out =
      part + static_cast<long long>(blockIdx.z) * (M + 1) * NC;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = m0 + ty * 4 + r;
    if (m > M) break;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int cc = c0 + tx * 4 + c;
      if (cc >= NC) break;
      out[static_cast<long long>(m) * NC + cc] = acc[r][c];
    }
  }
}

// out[e] = sum_{p < n_part} part[p*n + e], in the order p = 0, 1, ...
__global__ void sum_parts_kernel(const float* __restrict__ part, int n_part,
                                 long long n, float* __restrict__ out) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (e >= n) return;
  float v = 0.0f;
  for (int p = 0; p < n_part; ++p) v += part[p * n + e];
  out[e] = v;
}

#define RETURN_IF_LAUNCH_FAILED()                    \
  do {                                               \
    const cudaError_t err_ = cudaGetLastError();     \
    if (err_ != cudaSuccess) return (int)err_;       \
  } while (0)

// [dW; db] (M + 1, 3H) = sum over all (t, b) rows of [a_row, 1]^T G_row, in
// n_split fixed partials of the rows, then summed in order.
template <typename T>
int weight_grad(const T* a, long long sa_t, long long sa_b, int M,
                const float* g, int gap_at, int gap, float* part,
                int n_split, float* out, int n_steps, int B, int H,
                cudaStream_t stream) {
  const int NC = 3 * H;
  const long long n_q = static_cast<long long>(n_steps) * ((B + MK - 1) / MK);
  const long long q_per = (n_q + n_split - 1) / n_split;
  const dim3 grid((M + 1 + MT - 1) / MT, (NC + MT - 1) / MT, n_split);
  wgrad_kernel<T><<<grid, NT, 0, stream>>>(a, sa_t, sa_b, M, g, 4LL * H,
                                           gap_at, gap, NC, part, B, n_q,
                                           q_per);
  RETURN_IF_LAUNCH_FAILED();
  const long long n = static_cast<long long>(M + 1) * NC;
  sum_parts_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                     stream>>>(part, n_split, n, out);
  RETURN_IF_LAUNCH_FAILED();
  return 0;
}

// The backward of one layer. Step s of the sweep handles time t = T-1-s
// (or s when the forward ran reversed). x rows of step t start at
// x + t*sx_t, row b sx_b further on; hprev[t] is the state the forward
// step t read. dh must hold zeros on entry and holds dh0 on return. dx may
// be null (no input gradient). dwi (F+1, 3H) and dwh (H+1, 3H) receive the
// weight gradients with the bias gradient as their last row. g (T, B, 4H),
// dhz (B, H) and part (max(n_split_i*(F+1), n_split_h*(H+1)) * 3H floats)
// are scratch.
template <typename T>
int run_backward(const T* x, long long sx_t, long long sx_b,
                 const float* hprev, const float* dhs, const float* wi,
                 const float* bi, const float* wh, const float* bh, float* g,
                 float* dhz, float* dh, float* dx, float* part, int n_split_i,
                 int n_split_h, float* dwi, float* dwh, int n_steps, int B,
                 int F, int H, int reverse, cudaStream_t stream) {
  const long long BH = static_cast<long long>(B) * H;
  const long long G4 = 4LL * H;
  const dim3 step_grid((H + TH - 1) / TH, (B + TB - 1) / TB);
  const dim3 dh_grid((B + MT - 1) / MT, (H + MT - 1) / MT);
  for (int s = 0; s < n_steps; ++s) {
    const int t = reverse ? s : n_steps - 1 - s;
    float* gt = g + t * B * G4;
    gate_grad_kernel<T><<<step_grid, NT, 0, stream>>>(
        x + t * sx_t, sx_b, hprev + t * BH, dhs + t * BH, dh, wi, bi, wh, bh,
        gt, dhz, B, F, H);
    RETURN_IF_LAUNCH_FAILED();
    rowmm_kernel<<<dh_grid, NT, 0, stream>>>(gt, G4, 2 * H, H, wh, dhz, dh, B,
                                             H, 3 * H);
    RETURN_IF_LAUNCH_FAILED();
  }
  if (dx != nullptr) {
    const long long N = static_cast<long long>(n_steps) * B;
    const dim3 dx_grid(static_cast<unsigned>((N + MT - 1) / MT),
                       (F + MT - 1) / MT);
    rowmm_kernel<<<dx_grid, NT, 0, stream>>>(g, G4, 3 * H, 0, wi, nullptr, dx,
                                             N, F, 3 * H);
    RETURN_IF_LAUNCH_FAILED();
  }
  int err = weight_grad<T>(x, sx_t, sx_b, F, g, 3 * H, 0, part, n_split_i,
                           dwi, n_steps, B, H, stream);
  if (err != 0) return err;
  err = weight_grad<float>(hprev, BH, H, H, g, 2 * H, H, part, n_split_h, dwh,
                           n_steps, B, H, stream);
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Backward of the plain GRU layer over x (T, B, F) with strides
// (sx_t, sx_b, 1); hprev, dhs (T, B, H) float32 contiguous. See
// run_backward for the outputs and scratch.
int gru_bwd_f32(const void* x, long long sx_t, long long sx_b,
                const void* hprev, const void* dhs, const void* wi,
                const void* bi, const void* wh, const void* bh, void* g,
                void* dhz, void* dh0, void* dx, void* part, int n_split_i,
                int n_split_h, void* dwi, void* dwh, int T, int B, int F,
                int H, int reverse, void* stream) {
  return run_backward<float>(
      static_cast<const float*>(x), sx_t, sx_b,
      static_cast<const float*>(hprev), static_cast<const float*>(dhs),
      static_cast<const float*>(wi), static_cast<const float*>(bi),
      static_cast<const float*>(wh), static_cast<const float*>(bh),
      static_cast<float*>(g), static_cast<float*>(dhz),
      static_cast<float*>(dh0), static_cast<float*>(dx),
      static_cast<float*>(part), n_split_i, n_split_h,
      static_cast<float*>(dwi), static_cast<float*>(dwh), T, B, F, H, reverse,
      static_cast<cudaStream_t>(stream));
}

int gru_bwd_bf16(const void* x, long long sx_t, long long sx_b,
                 const void* hprev, const void* dhs, const void* wi,
                 const void* bi, const void* wh, const void* bh, void* g,
                 void* dhz, void* dh0, void* dx, void* part, int n_split_i,
                 int n_split_h, void* dwi, void* dwh, int T, int B, int F,
                 int H, int reverse, void* stream) {
  return run_backward<__nv_bfloat16>(
      static_cast<const __nv_bfloat16*>(x), sx_t, sx_b,
      static_cast<const float*>(hprev), static_cast<const float*>(dhs),
      static_cast<const float*>(wi), static_cast<const float*>(bi),
      static_cast<const float*>(wh), static_cast<const float*>(bh),
      static_cast<float*>(g), static_cast<float*>(dhz),
      static_cast<float*>(dh0), static_cast<float*>(dx),
      static_cast<float*>(part), n_split_i, n_split_h,
      static_cast<float*>(dwi), static_cast<float*>(dwh), T, B, F, H, reverse,
      static_cast<cudaStream_t>(stream));
}

// Backward of the windowed layer over raw bf16 frames, batch-major: frame f
// of batch row b starts at x + b*sx_b + f*C. Window w is frames
// [w*stride, w*stride + win), F = win*C; hprev, dhs (n_win, B, H). No input
// gradient.
int gru_wbwd_bf16(const void* x, long long sx_b, int C, int win, int stride,
                  const void* hprev, const void* dhs, const void* wi,
                  const void* bi, const void* wh, const void* bh, void* g,
                  void* dhz, void* dh0, void* part, int n_split_i,
                  int n_split_h, void* dwi, void* dwh, int n_win, int B, int H,
                  void* stream) {
  return run_backward<__nv_bfloat16>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<long long>(stride) * C, sx_b,
      static_cast<const float*>(hprev), static_cast<const float*>(dhs),
      static_cast<const float*>(wi), static_cast<const float*>(bi),
      static_cast<const float*>(wh), static_cast<const float*>(bh),
      static_cast<float*>(g), static_cast<float*>(dhz),
      static_cast<float*>(dh0), nullptr, static_cast<float*>(part),
      n_split_i, n_split_h, static_cast<float*>(dwi),
      static_cast<float*>(dwh), n_win, B, win * C, H, 0,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
