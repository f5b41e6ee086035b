// GRU layer forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the three forward Pallas kernels of
// cross_patient_speech_decoding_tpu/ops/pallas_gru.py:
//   - _fwd_kernel  (launched by _gru_forward, public gru_layer): GRU over a
//     time-major (T, B, F) input, forward or reversed in time;
//   - _wfwd_kernel (launched by _gru_win_forward, public
//     gru_layer_windowed): the layer-0 GRU over overlapping windows read
//     straight from the raw (frames, B, C) stream;
//   - _bifwd_kernel (launched by _gru_bidir_forward, public
//     gru_layer_bidir): both directions of a bidirectional layer in one
//     time loop.
// The first two launch one step kernel, gru_step_kernel<T>, templated over
// the data type of x (float or bf16); they differ only in where a step's
// rows start. The bidirectional kernel, gru_bistep_kernel<T>, runs the same
// step body (gru_step) on each direction's operands.
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
// tiled SIMT product in float32 (gate_products, gru_tile.cuh), then
// applies the gate math in registers and writes h_t. The (T, B, 3H) input
// projection is never stored. Row b of a step's input is F contiguous
// values at x + b*sx_b. For
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
//
// Bidirectional layer. One grid per step advances both directions, with
// blockIdx.z as the direction: at host step s the forward direction
// (z = 0) reads x[s] and writes hs_f[s], the reverse one (z = 1) reads
// x[T-1-s] and writes hs_b[T-1-s], each from the h_{t-1} of its own
// stream. Each CTA runs gru_step on its direction's operands, so each
// direction computes what gru_fwd computes for it, bit for bit. On the TPU
// the fusion put two independent recurrence products back to back on the
// one MXU; on Hopper the two directions are simply more CTAs of one
// launch. At the seq2seq bench's B=1000, H=500 one direction's grid is
// 16 x 16 = 256 CTAs against 264 resident slots (2 per SM on 132 SMs), so
// the fused grid of 512 CTAs runs in about two waves a step, as two
// one-direction launches do: what fusion saves is one launch a step (191
// at that bench's T' = 191). It is bound by operations as gru_fwd is
// (4*B*(F+H)*3H FLOPs a step) and runs the same float32 SIMT product; the
// faster forms above apply to it too. The weights come as two pointer
// sets, not stacked arrays: the port keeps fwd{l} and bwd{l} as separate
// parameters, and stacking them at every call would copy them.

#include "gru_tile.cuh"

namespace {

// One GRU step of this CTA's (TB x TH) block of h_t. x points at this
// step's row of batch 0: x[t] (plain) or the window's first frame
// (windowed); row b starts sx_b elements further on and holds F contiguous
// values.
template <typename T>
__device__ __forceinline__ void gru_step(
    Tiles& s, const T* __restrict__ x, long long sx_b,
    const float* __restrict__ hprev, const float* __restrict__ wi,
    const float* __restrict__ bi, const float* __restrict__ wh,
    const float* __restrict__ bh, float* __restrict__ hout, int B, int F,
    int H) {
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
    const float n = tanhf(acc_in[i] + bin + r * (acc_hn[i] + bhn));
    hout[o] = (1.0f - z) * n + z * hprev[o];
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, 2)
    gru_step_kernel(const T* __restrict__ x, long long sx_b,
                    const float* __restrict__ hprev,
                    const float* __restrict__ wi, const float* __restrict__ bi,
                    const float* __restrict__ wh, const float* __restrict__ bh,
                    float* __restrict__ hout, int B, int F, int H) {
  __shared__ __align__(16) Tiles s;
  gru_step<T>(s, x, sx_b, hprev, wi, bi, wh, bh, hout, B, F, H);
}

// One direction's operands of a bidirectional step: its input row, its
// h_{t-1}, its weights, and the hs row it writes.
template <typename T>
struct DirStep {
  const T* x;
  const float* hprev;
  const float* wi;
  const float* bi;
  const float* wh;
  const float* bh;
  float* hout;
};

// Bidirectional step (port of _bifwd_kernel, pallas_gru.py:140; see the
// note at the head): blockIdx.z picks the direction.
template <typename T>
__global__ void __launch_bounds__(NT, 2)
    gru_bistep_kernel(DirStep<T> fwd, DirStep<T> bwd, long long sx_b, int B,
                      int F, int H) {
  __shared__ __align__(16) Tiles s;
  const DirStep<T> d = blockIdx.z == 0 ? fwd : bwd;
  gru_step<T>(s, d.x, sx_b, d.hprev, d.wi, d.bi, d.wh, d.bh, d.hout, B, F,
              H);
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

// Host loop of the bidirectional layer: one grid of both directions per
// step. Step s: the forward direction at t = s reads h0_f at s == 0, else
// hs_f[t-1]; the reverse one at t = T-1-s reads h0_b at s == 0, else
// hs_b[t+1].
template <typename T>
int run_bidir(const T* x, long long sx_t, long long sx_b, const float* h0_f,
              const float* wi_f, const float* bi_f, const float* wh_f,
              const float* bh_f, const float* h0_b, const float* wi_b,
              const float* bi_b, const float* wh_b, const float* bh_b,
              float* hs_f, float* hs_b, int n_steps, int B, int F, int H,
              cudaStream_t stream) {
  const dim3 grid((H + TH - 1) / TH, (B + TB - 1) / TB, 2);
  const long long BH = static_cast<long long>(B) * H;
  for (int s = 0; s < n_steps; ++s) {
    const int tf = s;
    const int tb = n_steps - 1 - s;
    const DirStep<T> fwd{x + tf * sx_t, s == 0 ? h0_f : hs_f + (tf - 1) * BH,
                         wi_f, bi_f, wh_f, bh_f, hs_f + tf * BH};
    const DirStep<T> bwd{x + tb * sx_t, s == 0 ? h0_b : hs_b + (tb + 1) * BH,
                         wi_b, bi_b, wh_b, bh_b, hs_b + tb * BH};
    gru_bistep_kernel<T><<<grid, NT, 0, stream>>>(fwd, bwd, sx_b, B, F, H);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bifwd(const void* x, long long sx_t, long long sx_b, const void* h0_f,
          const void* wi_f, const void* bi_f, const void* wh_f,
          const void* bh_f, const void* h0_b, const void* wi_b,
          const void* bi_b, const void* wh_b, const void* bh_b, void* hs_f,
          void* hs_b, int T_, int B, int F, int H, void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  return run_bidir<T>(static_cast<const T*>(x), sx_t, sx_b, f(h0_f),
                      f(wi_f), f(bi_f), f(wh_f), f(bh_f), f(h0_b), f(wi_b),
                      f(bi_b), f(wh_b), f(bh_b), static_cast<float*>(hs_f),
                      static_cast<float*>(hs_b), T_, B, F, H,
                      static_cast<cudaStream_t>(stream));
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

// Bidirectional GRU layer over x (T, B, F) with strides (sx_t, sx_b, 1),
// one weight set per direction: hs_f and hs_b (T, B, H) float32,
// contiguous, both in the original time order.
int gru_bifwd_f32(const void* x, long long sx_t, long long sx_b,
                  const void* h0_f, const void* wi_f, const void* bi_f,
                  const void* wh_f, const void* bh_f, const void* h0_b,
                  const void* wi_b, const void* bi_b, const void* wh_b,
                  const void* bh_b, void* hs_f, void* hs_b, int T, int B,
                  int F, int H, void* stream) {
  return bifwd<float>(x, sx_t, sx_b, h0_f, wi_f, bi_f, wh_f, bh_f, h0_b,
                      wi_b, bi_b, wh_b, bh_b, hs_f, hs_b, T, B, F, H, stream);
}

int gru_bifwd_bf16(const void* x, long long sx_t, long long sx_b,
                   const void* h0_f, const void* wi_f, const void* bi_f,
                   const void* wh_f, const void* bh_f, const void* h0_b,
                   const void* wi_b, const void* bi_b, const void* wh_b,
                   const void* bh_b, void* hs_f, void* hs_b, int T, int B,
                   int F, int H, void* stream) {
  return bifwd<__nv_bfloat16>(x, sx_t, sx_b, h0_f, wi_f, bi_f, wh_f, bh_f,
                              h0_b, wi_b, bi_b, wh_b, bh_b, hs_f, hs_b, T, B,
                              F, H, stream);
}

}  // extern "C"
