// GRU layer backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the two backward Pallas kernels of
// cross_patient_speech_decoding_tpu/ops/pallas_gru.py:
//   - _bwd_kernel  (launched by _gru_backward, VJP of gru_layer): the
//     backward of a GRU over a time-major (T, B, F) input, forward or
//     reversed in time; dx = dgi Wi^T when need_dx is set;
//   - _wbwd_kernel (launched by _gru_win_backward, VJP of
//     gru_layer_windowed): the backward of the layer-0 GRU over overlapping
//     windows of the raw frames. The TPU kernel forms no input gradient
//     (its frames are data); here, when the frames train (the output of a
//     trainable layer below), the windows' dgi Wi^T is formed as dx is and
//     folded back onto the frames (fold_windows_kernel).
// Both emit dh0, dWi, dWh and the two biases' gradients, summed over batch
// and time with the per-step accumulate of _accum_dw (pallas_gru.py:536-541)
// as the contract.
//
// Math of one step at time t (pallas_gru.py:602-633), the gates recomputed
// from (x_t, h_{t-1}) as in the forward, ghn = h_{t-1} Wh_n + bh_n, dh the
// gradient carried from the later step:
//   d   = dh + dhs[t]
//   dz  = d (h_{t-1} - n) z (1 - z),   dn = d (1 - z)(1 - n^2)
//   dr  = dn ghn r (1 - r),            dgn = dn r
//   dgi = [dr, dz, dn]  (gradient of x Wi + bi)
//   dgh = [dr, dz, dgn] (gradient of h Wh + bh)
//   dh' = d z + dgh Wh^T,   dx[t] = dgi Wi^T
//   dWi += x_t^T dgi,  dWh += h_{t-1}^T dgh,  dbi += sum_b dgi,  dbh += ...
//
// Design. The TPU kernel carries dh, dWi, dWh and db in VMEM across a grid
// that runs in order. On Hopper only dh' = d z + dgh Wh^T depends on the
// step before: the gate pre-activations read x and hprev, which are inputs
// of the backward, and the weight and input gradients read the gate
// gradients of all steps at once. So the backward runs in three phases,
// every product on the tensor cores (gru_mma.cuh: 3xTF32 mma.sync, a
// 3-stage cp.async ring):
//   1. Before the sweep, the gate pre-activations of all N = T B rows as
//      three products over [x_t | h_{t-1}], biases added in the epilogue,
//      into the scratch stream g (T, B, 4H) as [r_pre | z_pre | in_pre |
//      hn_pre]: r and z take x Wi + h Wh, n keeps x Wi_n and h Wh_n apart
//      (r scales the second). From GRU_WGMMA_MIN_ROWS rows on these and
//      dx take wgmma from images of Wi, Wh and Wi^T written at the call's
//      start into the caller's wimg scratch (gru_mma.cuh). The windowed
//      layer's x is the overlapping (n_win, B, win*C) view of its
//      batch-major frames (ops/gru.py: _windows), read in place.
//   2. The sweep, one step at a time from the host loop below (the launch
//      boundary is the grid-wide barrier), two launches a step:
//      step_grad_kernel reads g[t], hprev[t], dhs[t] and the carried dh,
//      overwrites g[t] in place with [dr | dz | dn | dgn] and writes d z;
//      then the tensor-core product dgh Wh^T (B x 3H by 3H x H), dgh read
//      from g[t] as two column runs ([dr | dz] and dgn), split over K into
//      a few partial sums so that its small grid fills the card; the next
//      step's elementwise pass forms dh' = d z + the partials in a fixed
//      order.
//   3. After the sweep, off the recurrence: dx = dgi Wi^T over all N rows
//      when asked (for the windowed layer the windows' gradient, which
//      gru_fold_windows then sums onto the frames), and [dWi; dbi] = [x, 1]^T dgi, [dWh; dbh] = [hprev, 1]^T
//      dgh, the bias row (the ones column's) summed from the B tiles by the
//      CTAs of the first row block. The N rows of each weight gradient are
//      split over CTAs into a fixed number of partial sums, which
//      sum_parts_kernel adds in a fixed order: no float atomics, so two runs
//      give the same gradients bit for bit.
// The elementwise pass stays its own launch: fusing it into the dh'
// product's A loads would have every column block recompute its rows'
// gradients from g, and the pass is a small share of the step. So does the
// windows' fold: the dx product keeps the wgmma route and epilogue it has
// for gru_bwd, and the fold reads the product's output once (n_win B win C
// floats, 0.45 GB at B 64 and 244 windows of 14 x 512) at the memory's
// rate, a small share of the product's time at that shape.
//
// What bounds it. The products are 2 N 3H (3F + 3H) FLOPs (recompute,
// dh Wh^T, dx, dWi, dWh; 2F + 3H without dx) against O(N (F + H)) bytes:
// bound by operations, at the card's 495 TFLOP/s TF32 rate over the three
// products of the split, 165 TFLOP/s float32-equivalent; the products whose
// A is bf16 (x's half of the recompute and dWi, for bf16 x and the frames)
// take two, 247.5 TFLOP/s. The g stream
// (16 N H bytes, 2.4 GB a layer at fig_5 width, freed by the caller after
// the layer) is written once, read and rewritten once in the sweep, and
// read three times after it: ~10 GB, a few ms beside the products.

#include "gru_mma.cuh"
#include "gru_tile.cuh"

namespace {

// The carried gradient dh = dhz + dhp[0] + ... + dhp[n_part - 1] (B, H),
// summed in that order: d z of the step before and the n_part partial sums
// of its dgh Wh^T over K; 0 when n_part = 0 (the first step of the sweep).
__device__ __forceinline__ float carried(const float* __restrict__ dhz,
                                         const float* __restrict__ dhp,
                                         int n_part, long long BH,
                                         long long o) {
  if (n_part == 0) return 0.0f;
  float v = dhz[o];
  for (int z = 0; z < n_part; ++z) v += dhp[z * BH + o];
  return v;
}

// Gate gradients of step t for one (b, j): g points at the step's (B, 4H)
// pre-activations [r_pre | z_pre | in_pre | hn_pre] (biases in), which are
// replaced by [dr | dz | dn | dgn]; dhz (read as the carried gradient's
// first term, then) = d * z.
__global__ void step_grad_kernel(float* __restrict__ g,
                                 const float* __restrict__ hprev,
                                 const float* __restrict__ dhs,
                                 float* __restrict__ dhz,
                                 const float* __restrict__ dhp, int n_part,
                                 int B, int H) {
  const long long BH = static_cast<long long>(B) * H;
  const long long o = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (o >= BH) return;
  const int b = static_cast<int>(o / H);
  const int j = static_cast<int>(o - static_cast<long long>(b) * H);
  float* __restrict__ gb = g + static_cast<long long>(b) * 4 * H;
  const float r = sigmoid_f32(gb[j]);
  const float z = sigmoid_f32(gb[H + j]);
  const float ghn = gb[3 * H + j];
  const float n = tanhf(gb[2 * H + j] + r * ghn);
  const float d = carried(dhz, dhp, n_part, BH, o) + dhs[o];
  const float dz = d * (hprev[o] - n) * z * (1.0f - z);
  const float dn = d * (1.0f - z) * (1.0f - n * n);
  gb[j] = dn * ghn * r * (1.0f - r);
  gb[H + j] = dz;
  gb[2 * H + j] = dn;
  gb[3 * H + j] = dn * r;
  dhz[o] = d * z;
}

// The frames' gradient from the windows': dx[b, f, c] (batch-major, T
// frames a row) sums dxw[k, b, (f - k stride) C + c] over the windows k
// that hold frame f (k stride <= f < k stride + win), in the order k = 0,
// 1, ... from 0; 0 where no window holds f. One thread an element, c
// fastest, so a warp reads runs of a window row.
__global__ void fold_windows_kernel(const float* __restrict__ dxw,
                                    float* __restrict__ dx, int T, int B,
                                    int C, int win, int stride, int n_win) {
  const long long n = static_cast<long long>(B) * T * C;
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (e >= n) return;
  const long long bf = e / C;
  const int c = static_cast<int>(e - bf * C);
  const int b = static_cast<int>(bf / T);
  const int f = static_cast<int>(bf - static_cast<long long>(b) * T);
  const int k_lo = f < win ? 0 : (f - win + stride) / stride;
  int k_hi = f / stride;
  k_hi = k_hi < n_win - 1 ? k_hi : n_win - 1;
  const long long F = static_cast<long long>(win) * C;
  float v = 0.0f;
  for (int k = k_lo; k <= k_hi; ++k) {
    v += dxw[(static_cast<long long>(k) * B + b) * F +
             static_cast<long long>(f - k * stride) * C + c];
  }
  dx[e] = v;
}

// dh0 = the gradient carried out of the last step
__global__ void carried_kernel(const float* __restrict__ dhz,
                               const float* __restrict__ dhp, int n_part,
                               long long BH, float* __restrict__ dh) {
  const long long o = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (o < BH) dh[o] = carried(dhz, dhp, n_part, BH, o);
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

// The step product's K split: about one wave of CTAs (MIN_BLOCKS MmaSmall
// CTAs on each of the H100's 132 SMs), at most MAX_DH_PARTS parts.
constexpr int DH_CTAS = MmaSmall::MIN_BLOCKS * 132;
constexpr int MAX_DH_PARTS = 4;
// The weight gradients' row split: as many CTAs as fit in four waves of
// one MmaBig CTA on each SM, at most DW_MAX_SPLIT partials.
constexpr long long DW_CTAS = 4 * 132;
constexpr long long DW_MAX_SPLIT = 64;

// How a backward of n_steps x B rows splits its sums, from the shapes
// alone (so a run repeats its sums bit for bit), and the floats of the
// `part` scratch that the splits fill.
struct BwdPlan {
  int split_i, split_h;  // partials of [dWi; dbi] and [dWh; dbh]
  int n_kz, kt_per;      // the step product's K split, tiles per part
  long long part;
};

// Partials of a [dW; db] (M + 1, 3H) sum over N rows in tiles of BK (the
// bias row rides on the first row block); no partial is empty.
int dw_split(int M, int H, long long N) {
  const long long tiles = static_cast<long long>(
                              (M + MmaBig::BM - 1) / MmaBig::BM) *
                          ((3 * H + MmaBig::BN - 1) / MmaBig::BN);
  const long long n_q = (N + MmaBig::BK - 1) / MmaBig::BK;
  long long split = DW_CTAS / tiles;
  split = split < DW_MAX_SPLIT ? split : DW_MAX_SPLIT;
  split = split < n_q ? split : n_q;
  split = split < 1 ? 1 : split;
  const long long q_per = (n_q + split - 1) / split;
  return static_cast<int>((n_q + q_per - 1) / q_per);
}

BwdPlan bwd_plan(int n_steps, int B, int F, int H) {
  BwdPlan pl;
  const long long N = static_cast<long long>(n_steps) * B;
  pl.split_i = dw_split(F, H, N);
  pl.split_h = dw_split(H, H, N);
  const int tiles = ((B + MmaSmall::BM - 1) / MmaSmall::BM) *
                    ((H + MmaSmall::BN - 1) / MmaSmall::BN);
  const int k_tiles = (2 * H + MmaSmall::BK - 1) / MmaSmall::BK +
                      (H + MmaSmall::BK - 1) / MmaSmall::BK;
  int n_kz = (DH_CTAS + tiles / 2) / tiles;
  n_kz = n_kz < 1 ? 1 : (n_kz > MAX_DH_PARTS ? MAX_DH_PARTS : n_kz);
  n_kz = n_kz > k_tiles ? k_tiles : n_kz;
  pl.kt_per = (k_tiles + n_kz - 1) / n_kz;
  pl.n_kz = (k_tiles + pl.kt_per - 1) / pl.kt_per;
  const long long H3 = 3LL * H;
  const long long a = pl.split_i * (F + 1LL) * H3;
  const long long b = pl.split_h * (H + 1LL) * H3;
  const long long c = static_cast<long long>(pl.n_kz) * B * H;
  pl.part = a > b ? (a > c ? a : c) : (b > c ? b : c);
  return pl;
}

// [dW; db] (M + 1, 3H) = sum over all N data rows of [A_row, 1]^T G_row,
// G the step's gate gradients at columns 0..3H of g, or (gapped)
// [dr | dz | dgn]; n_split fixed partials of the rows, then summed in order.
template <typename T>
int weight_grad(const MmaSeg& a, int M, const float* g, bool gapped,
                float* part, int n_split, float* out, long long N, int H,
                cudaStream_t stream) {
  const int NC = 3 * H;
  MmaArgs p = out_args(part, NC, 0, M, NC);
  p.seg[0] = a;
  set_b(p.seg[0], g, 4LL * H, !gapped || H % 4 == 0);
  if (gapped) {
    p.gap_at = 2 * H;
    p.gap = H;
  }
  p.k_total = N;
  const long long k_tiles = (N + MmaBig::BK - 1) / MmaBig::BK;
  p.k_per = (k_tiles + n_split - 1) / n_split * MmaBig::BK;
  p.out_z = static_cast<long long>(M + 1) * NC;
  RETURN_IF_FAILED((launch_mma<MmaBig, T, true, true>(p, n_split, stream)));
  const long long n = p.out_z;
  sum_parts_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                     stream>>>(part, n_split, n, out);
  RETURN_IF_LAUNCH_FAILED();
  return 0;
}

// The images of a backward's weights in its wimg scratch, one after the
// other: Wi (F x 3H) and Wh (H x 3H), each in runs [0, 2H) and [2H, 3H)
// as the recompute's products take them, then Wi^T (3H x F) for dx.
struct BwdImages {
  WImage wi, wh, wit;
  long long floats;
};

BwdImages bwd_images(float* wimg, int F, int H, bool need_dx) {
  BwdImages im;
  im.wi = wimage(wimg, F, 3 * H, 2 * H);
  long long off = wimage_floats(im.wi);
  im.wh = wimage(wimg == nullptr ? nullptr : wimg + off, H, 3 * H, 2 * H);
  off += wimage_floats(im.wh);
  im.wit = wimage(wimg == nullptr ? nullptr : wimg + off, 3 * H, F, F);
  im.floats = off + (need_dx ? wimage_floats(im.wit) : 0);
  return im;
}

// The backward of one layer. Step s of the sweep handles time t = T-1-s
// (or s when the forward ran reversed). x rows (type T) of step t start at
// x + t*sx_t, row b sx_b further on; hprev[t] is the state the forward
// step t read. dh receives dh0. dx may
// be null (no input gradient). dwi (F+1, 3H) and dwh (H+1, 3H) receive the
// weight gradients with the bias gradient as their last row. g (T, B, 4H),
// dhz (B, H), part and wimg (gru_bwd_sizes floats; wimg null below the
// wgmma route's rows) are scratch.
template <typename T>
int run_backward(const void* x, long long sx_t, long long sx_b,
                 const float* hprev, const float* dhs, const float* wi,
                 const float* bi, const float* wh, const float* bh, float* g,
                 float* dhz, float* dh, float* dx, float* part, float* dwi,
                 float* dwh, float* wimg, int n_steps, int B, int F, int H,
                 int reverse, cudaStream_t stream) {
  const long long N = static_cast<long long>(n_steps) * B;
  const long long BH = static_cast<long long>(B) * H;
  const long long G4 = 4LL * H;
  const long long H3 = 3LL * H;
  const BwdPlan pl = bwd_plan(n_steps, B, F, H);
  const MmaSeg xs = x_seg<T>(static_cast<const T*>(x), sx_t, sx_b, B, F);
  const MmaSeg hs = f32_seg(hprev, H, H);
  const BwdImages im = bwd_images(wimg, F, H, dx != nullptr);
  const bool on_wgmma = wimg != nullptr && wgmma_rows(N);
  if (on_wgmma) {
    RETURN_IF_FAILED(presplit(im.wi, wi, H3, false, stream));
    RETURN_IF_FAILED(presplit(im.wh, wh, H3, false, stream));
    if (dx != nullptr) {
      RETURN_IF_FAILED(presplit(im.wit, wi, H3, true, stream));
    }
  }

  // 1. gate pre-activations of all rows: [r | z] over [x | h], n's input
  // half over x, its recurrent half over h
  {
    MmaArgs p = out_args(g, G4, 0, N, 2 * H);
    p.seg[0] = xs;
    set_b(p.seg[0], wi, H3);
    p.seg[1] = hs;
    set_b(p.seg[1], wh, H3);
    p.bias0 = bi;
    p.bias1 = bh;
    RETURN_IF_FAILED((weight_product<T, true>(p, &im.wi, &im.wh, 0,
                                              on_wgmma, stream)));
  }
  {
    MmaArgs p = out_args(g, G4, 2 * H, N, H);
    p.seg[0] = xs;
    set_b(p.seg[0], wi + 2 * H, H3);
    p.bias0 = bi + 2 * H;
    RETURN_IF_FAILED((weight_product<T, true>(p, &im.wi, nullptr, 2 * H,
                                              on_wgmma, stream)));
  }
  {
    MmaArgs p = out_args(g, G4, 3 * H, N, H);
    p.seg[1] = hs;
    set_b(p.seg[1], wh + 2 * H, H3);
    p.bias0 = bh + 2 * H;
    RETURN_IF_FAILED((weight_product<T, true>(p, nullptr, &im.wh, 2 * H,
                                              on_wgmma, stream)));
  }

  // 2. the sweep. dgh Wh^T = [dr | dz] Wh[:, :2H]^T + dgn Wh[:, 2H:]^T is
  // split over K into n_kz partial sums (into part), so that the step's
  // small grid fills the card; the next step's elementwise pass adds them
  // to d z in a fixed order.
  const int n_kz = pl.n_kz;
  const unsigned ew_blocks = static_cast<unsigned>((BH + 255) / 256);
  for (int s = 0; s < n_steps; ++s) {
    const int t = reverse ? s : n_steps - 1 - s;
    float* gt = g + static_cast<long long>(t) * B * G4;
    step_grad_kernel<<<ew_blocks, 256, 0, stream>>>(
        gt, hprev + t * BH, dhs + t * BH, dhz, part, s == 0 ? 0 : n_kz, B,
        H);
    RETURN_IF_LAUNCH_FAILED();
    MmaArgs p = out_args(part, H, 0, B, H);
    p.seg[0] = f32_seg(gt, G4, 2 * H);
    set_b(p.seg[0], wh, H3);
    p.seg[1] = f32_seg(gt + 3 * H, G4, H);
    set_b(p.seg[1], wh + 2 * H, H3);
    p.kt_per = pl.kt_per;
    p.out_z = BH;
    RETURN_IF_FAILED(
        (launch_mma<MmaSmall, float, false, false>(p, n_kz, stream)));
  }
  carried_kernel<<<ew_blocks, 256, 0, stream>>>(dhz, part, n_kz, BH, dh);
  RETURN_IF_LAUNCH_FAILED();

  // 3. off the recurrence
  if (dx != nullptr) {
    MmaArgs p = out_args(dx, F, 0, N, F);
    p.seg[0] = f32_seg(g, G4, 3 * H);
    set_b(p.seg[0], wi, H3);
    RETURN_IF_FAILED((weight_product<float, false>(p, &im.wit, nullptr, 0,
                                                   on_wgmma, stream)));
  }
  RETURN_IF_FAILED(weight_grad<T>(xs, F, g, false, part, pl.split_i, dwi, N,
                                  H, stream));
  RETURN_IF_FAILED(weight_grad<float>(hs, H, g, true, part, pl.split_h, dwh,
                                      N, H, stream));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The floats of the scratch that a backward of n_steps x B rows, F inputs
// and H units (dx formed when need_dx) needs: into *part the partial sums'
// (the splits that fill it are decided here alone), into *wimg the
// weights' images (0 where its weight products take mma.sync; then wimg
// may be null).
int gru_bwd_sizes(int n_steps, int B, int F, int H, int need_dx,
                  long long* part, long long* wimg) {
  *part = bwd_plan(n_steps, B, F, H).part;
  *wimg = wgmma_rows(static_cast<long long>(n_steps) * B)
              ? bwd_images(nullptr, F, H, need_dx != 0).floats
              : 0;
  return 0;
}

// The weight products launched by route since the last reset: counts[0]
// on wgmma, counts[1] on mma.sync; zeroed after the read when `reset`.
int gru_bwd_counts(long long* counts, int reset) {
  read_routes(counts, reset);
  return 0;
}

// Backward of the GRU layer over x (T, B, F), bf16 where x_bf16 else
// float32, with strides (sx_t, sx_b, 1); hprev, dhs (T, B, H) float32
// contiguous. See run_backward for the outputs and scratch.
int gru_bwd(const void* x, long long sx_t, long long sx_b, int x_bf16,
            const float* hprev, const float* dhs, const float* wi,
            const float* bi, const float* wh, const float* bh, float* g,
            float* dhz, float* dh0, float* dx, float* part, float* dwi,
            float* dwh, float* wimg, int T, int B, int F, int H, int reverse,
            void* stream) {
  const auto run =
      x_bf16 ? &run_backward<__nv_bfloat16> : &run_backward<float>;
  return run(x, sx_t, sx_b, hprev, dhs, wi, bi, wh, bh, g, dhz, dh0, dx,
             part, dwi, dwh, wimg, T, B, F, H, reverse,
             static_cast<cudaStream_t>(stream));
}

// The frames' gradient dx (B, T, C) float32, contiguous, T frames a row,
// from the gradient dxw (n_win, B, win*C) float32 of the windows
// [w*stride, w*stride + win) of the frames (fold_windows_kernel).
int gru_fold_windows(const float* dxw, float* dx, int T, int B, int C,
                     int win, int stride, int n_win, void* stream) {
  const long long n = static_cast<long long>(B) * T * C;
  fold_windows_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      dxw, dx, T, B, C, win, stride, n_win);
  RETURN_IF_LAUNCH_FAILED();
  return 0;
}

}  // extern "C"
