// GRU layer forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the two forward Pallas kernels of
// cross_patient_speech_decoding_tpu/ops/pallas_gru.py:
//   - _fwd_kernel  (launched by _gru_forward, public gru_layer): GRU over a
//     time-major (T, B, F) input, forward or reversed in time;
//   - _wfwd_kernel (launched by _gru_win_forward, public
//     gru_layer_windowed): the layer-0 GRU over overlapping windows read
//     straight from the raw (frames, B, C) stream.
// Both launch one step kernel, gru_step_kernel<T>, templated over the data
// type of x (float or bf16); they differ only in where a step's rows start.
//
// Gate math (torch convention, pallas_gru.py:25-31), gate order (r, z, n):
//   r = sigmoid(x Wi_r + bi_r + h Wh_r + bh_r)
//   z = sigmoid(x Wi_z + bi_z + h Wh_z + bh_z)
//   n = tanh(x Wi_n + bi_n + r * (h Wh_n + bh_n))
//   h' = (1 - z) * n + z * h
//
// Design. Every step needs all of h_{t-1}, so a step is one grid and the
// host loop below launches one grid per step on the caller's stream: the
// launch boundary is the grid-wide barrier. Each CTA owns a (TB x TH)
// block of h_t (TB batch rows, TH hidden columns) and computes, for those
// columns of all three gates, x_t Wi and h_{t-1} Wh as a shared-memory
// tiled SIMT product in float32 (KT-deep tiles of x or h and of the three
// gate column slices of Wi or Wh; one loop runs over the F input tiles,
// then the H recurrent ones, with the next tile's global loads staged in
// registers while the current tile is multiplied), then applies the gate
// math in registers and writes h_t. The (T, B, 3H) input projection is never
// stored. Row b of a step's input is F contiguous values at x + b*sx_b. For
// the windowed kernel the frames are batch-major ((B, frames, C) memory,
// frame stride C), so window w of batch row b, flattened time-major then
// channel (_window_row, pallas_gru.py:254-260), is the run of win*C values
// that starts at frame w*stride: the (n_win, B, win*C) window stream is
// never built, and a window row is read exactly like a plain row.
//
// What bounds it. Per step the work is 2*B*(F+H)*3H FLOPs against
// B*(F+H) + (F+H)*3H inputs: at B=2000, H=512 it is far above the card's
// operations-per-byte line, so the kernel is bound by operations. As
// written it runs in float32 on the SIMT units (67 TFLOP/s peak), which
// keeps it within float32 roundoff of the plain version. Each warp issues
// 24 FMA instructions per k-step beside 5 shared-memory loads (two float4
// reads of the A tile that the whole warp shares, three weight reads), and
// __launch_bounds__ caps a thread at 128 registers so that 2 CTAs fit an
// SM (chip_smoke.py prints ptxas's count at build), so issue slots and
// latency, not the FMA rate alone, set its pace. Wi and Wh are re-read
// from L2 by every CTA at every step (3 MB of Wh in f32 at H=512 does not
// fit one SM's 227 KB). Faster forms, for later work: larger per-thread
// tiles, tensor cores (bf16 wgmma, or split-TF32 to stay near float32)
// with TMA-fed tiles, and a persistent kernel that keeps a slice of Wh
// resident per SM and syncs the grid once per step.

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

// One GRU step. x points at this step's row of batch 0: x[t] (plain) or
// the window's first frame (windowed); row b starts sx_b elements further
// on and holds F contiguous values.
template <typename T>
__global__ void __launch_bounds__(NT, 2)
    gru_step_kernel(const T* __restrict__ x, long long sx_b,
                    const float* __restrict__ hprev,
                    const float* __restrict__ wi, const float* __restrict__ bi,
                    const float* __restrict__ wh, const float* __restrict__ bh,
                    float* __restrict__ hout, int B, int F, int H) {
  __shared__ __align__(16) Tiles s;

  const int tx = threadIdx.x % TH;
  const int ty = threadIdx.x / TH;
  const int b0 = blockIdx.y * TB;
  const int j0 = blockIdx.x * TH;
  const int nx = (F + KT - 1) / KT;
  const int n_tiles = nx + (H + KT - 1) / KT;

  float acc_r[RPT], acc_z[RPT], acc_in[RPT], acc_hn[RPT];
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

  const int j = j0 + tx;
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
    const float n = tanhf(acc_in[i] + bin + r * (acc_hn[i] + bhn));
    hout[o] = (1.0f - z) * n + z * hprev[o];
  }
}

// Host loop: one grid per step. Step s handles time t = s (or T-1-s when
// reverse); its rows start at x + t*sx_step, and its h_{t-1} is h0 at
// s == 0, else the hs row written by the previous step. Returns the first
// launch error, else cudaGetLastError().
template <typename T>
int run_layer(const T* x, long long sx_step, long long sx_b, const float* h0,
              const float* wi, const float* bi, const float* wh,
              const float* bh, float* hs, int n_steps, int B, int F, int H,
              int reverse, cudaStream_t stream) {
  const dim3 grid((H + TH - 1) / TH, (B + TB - 1) / TB);
  const long long BH = static_cast<long long>(B) * H;
  for (int s = 0; s < n_steps; ++s) {
    const int t = reverse ? n_steps - 1 - s : s;
    const float* hp = s == 0 ? h0 : hs + (reverse ? t + 1 : t - 1) * BH;
    gru_step_kernel<T><<<grid, NT, 0, stream>>>(
        x + t * sx_step, sx_b, hp, wi, bi, wh, bh, hs + t * BH, B, F, H);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Plain GRU layer over x (T, B, F) with strides (sx_t, sx_b, 1):
// hs (T, B, H) float32, contiguous.
int gru_fwd_f32(const void* x, long long sx_t, long long sx_b,
                const void* h0, const void* wi, const void* bi,
                const void* wh, const void* bh, void* hs, int T, int B,
                int F, int H, int reverse, void* stream) {
  return run_layer<float>(
      static_cast<const float*>(x), sx_t, sx_b,
      static_cast<const float*>(h0), static_cast<const float*>(wi),
      static_cast<const float*>(bi), static_cast<const float*>(wh),
      static_cast<const float*>(bh), static_cast<float*>(hs), T, B, F, H,
      reverse, static_cast<cudaStream_t>(stream));
}

int gru_fwd_bf16(const void* x, long long sx_t, long long sx_b,
                 const void* h0, const void* wi, const void* bi,
                 const void* wh, const void* bh, void* hs, int T, int B,
                 int F, int H, int reverse, void* stream) {
  return run_layer<__nv_bfloat16>(
      static_cast<const __nv_bfloat16*>(x), sx_t, sx_b,
      static_cast<const float*>(h0), static_cast<const float*>(wi),
      static_cast<const float*>(bi), static_cast<const float*>(wh),
      static_cast<const float*>(bh), static_cast<float*>(hs), T, B, F, H,
      reverse, static_cast<cudaStream_t>(stream));
}

// Windowed GRU layer over raw bf16 frames, batch-major: frame f of batch
// row b starts at x + b*sx_b + f*C and holds C contiguous channels. Window
// w is frames [w*stride, w*stride + win), F = win*C; hs (n_win, B, H)
// float32, contiguous.
int gru_wfwd_bf16(const void* x, long long sx_b, int C, int win, int stride,
                  const void* h0, const void* wi, const void* bi,
                  const void* wh, const void* bh, void* hs, int n_win, int B,
                  int H, void* stream) {
  return run_layer<__nv_bfloat16>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<long long>(stride) * C, sx_b,
      static_cast<const float*>(h0), static_cast<const float*>(wi),
      static_cast<const float*>(bi), static_cast<const float*>(wh),
      static_cast<const float*>(bh), static_cast<float*>(hs), n_win, B,
      win * C, H, 0, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
