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
//      boundary is the grid-wide barrier), one launch a step after an
//      elementwise launch that forms the first step's gate gradients
//      (nothing carried in): it overwrites g[t] in place with
//      [dr | dz | dn | dgn] and writes d z. The launch of step t
//      (bwd_step_kernel) forms dh' = dgh Wh^T (B x 3H by 3H x H), dgh read
//      from g[t] as two column runs ([dr | dz] against Wh[:, :2H]^T, dgn
//      against Wh[:, 2H:]^T). Where a step has few tiles (B = 64, H = 768:
//      12 tiles of 132 SMs) one tile's K is split over a thread-block
//      cluster of S CTAs (step_split: S in {1, 2, 4, 8, 16}, from the shape
//      and the card alone): rank r multiplies its contiguous run of the
//      k-tiles, leaves its partial tile in its own shared memory (the
//      ring, free by then) and, after a cluster barrier, sums rows
//      [r BM/S, (r+1) BM/S) of the S partial tiles through distributed
//      shared memory in rank order 0..S-1, as the forward's step kernel
//      does (gru_fwd.cu). The rank then holds the whole dh'(b, j) of its
//      rows, adds d z of step t and applies the gate gradients of the next
//      step t' at the same (b, j): reads g[t'], hprev[t'] and dhs[t'],
//      overwrites g[t'] and writes d' z' (dh0 after the last step). That
//      is elementwise in (b, j), each (b, j) has one owner in the grid,
//      and the launch reads g[t] and writes only g[t'] and d z, so the
//      launch boundary stays the barrier between steps: T + 1 launches a
//      call. The epilogue reads and writes runs of four units a thread
//      from the block's sums in shared memory, at S = 1 too (the CTA's own
//      tile): read from the accumulators' fragments (two units a thread,
//      eight rows a warp), the same epilogue ran a step at fig_5's
//      B = 2000 in 139 µs against 102 on an H100 (PERF.md, section 6).
//      The clusters are placed by the load-balancing policy
//      (cluster_config, gru_mma.cuh). No float atomics and no global
//      partials: the sums run in a fixed order from the shape alone.
//   3. After the sweep, off the recurrence: dx = dgi Wi^T over all N rows
//      when asked (for the windowed layer the windows' gradient, which
//      gru_fold_windows then sums onto the frames), and [dWi; dbi] = [x, 1]^T dgi, [dWh; dbh] = [hprev, 1]^T
//      dgh, the bias row (the ones column's) summed from the B tiles by the
//      CTAs of the first row block. The N rows of each weight gradient are
//      split over CTAs into a fixed number of partial sums, which
//      sum_parts_kernel adds in a fixed order: no float atomics, so two runs
//      give the same gradients bit for bit.
// The gate gradients are formed once, in the product's epilogue, where
// one CTA holds the whole K sum of its (b, j); forming them in the A loads
// instead would have every column block recompute its rows' gradients
// from g. The windows' fold stays its own launch: the dx product keeps the
// wgmma route and epilogue it has for gru_bwd, and the fold reads the
// product's output once (n_win B win C floats, 0.45 GB at B 64 and 244
// windows of 14 x 512) at the memory's rate, a small share of the
// product's time at that shape.
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

#include <cooperative_groups.h>

#include "gru_mma.cuh"
#include "gru_tile.cuh"

namespace {

namespace cg = cooperative_groups;

// The gate gradients of one step at one (b, j) from d = the gradient
// carried into it + dhs: pre holds its pre-activations [r | z | in | hn]
// (biases in) and receives [dr | dz | dn | dgn]; returns d z.
__device__ __forceinline__ float gate_grads(float (&pre)[4], float hprev,
                                            float d) {
  const float r = sigmoid_f32(pre[0]);
  const float z = sigmoid_f32(pre[1]);
  const float ghn = pre[3];
  const float n = tanhf(pre[2] + r * ghn);
  const float dz = d * (hprev - n) * z * (1.0f - z);
  const float dn = d * (1.0f - z) * (1.0f - n * n);
  pre[0] = dn * ghn * r * (1.0f - r);
  pre[1] = dz;
  pre[2] = dn;
  pre[3] = dn * r;
  return d * z;
}

// The first step of the sweep, one thread a (b, j): nothing carried in.
// g is the step's (B, 4H) [r | z | in | hn] rows, replaced by its gate
// gradients; dhz receives d z.
__global__ void first_step_kernel(float* __restrict__ g,
                                  const float* __restrict__ hprev,
                                  const float* __restrict__ dhs,
                                  float* __restrict__ dhz, int B, int H) {
  const long long BH = static_cast<long long>(B) * H;
  const long long o = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (o >= BH) return;
  const int b = static_cast<int>(o / H);
  const int j = static_cast<int>(o - static_cast<long long>(b) * H);
  float* gb = g + static_cast<long long>(b) * 4 * H + j;
  float pre[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) pre[q] = gb[q * H];
  dhz[o] = gate_grads(pre, hprev[o], dhs[o]);
#pragma unroll
  for (int q = 0; q < 4; ++q) gb[q * H] = pre[q];
}

// One launch of the sweep: step t's product and step t''s gate gradients.
// seg[0] is [dr | dz] of g[t] against Wh[:, :2H]^T, seg[1] dgn of g[t]
// against Wh[:, 2H:]^T (K = 3H in two runs of k-tiles). gn, hprev and dhs
// are step t''s rows; gn null at the last step, whose carried gradient
// goes to dh0.
struct BwdStepArgs {
  MmaSeg seg[2];
  float* gn;
  const float* hprev;
  const float* dhs;
  float* dhz;
  float* dh0;
  int B, H;
  int vec;  // H % 4 == 0 and every stream 16-byte aligned: float4 access
};

// The epilogue's operands at units j..j+3 of row m (those below H): d z
// of step t, and step t''s hprev, dhs and pre-activations r, z, in, hn.
struct EpIn {
  float dhz[4], hp[4], ds[4], pre[4][4];
};

__device__ __forceinline__ void load4(const float* __restrict__ a, int n,
                                      bool vec, float (&v)[4]) {
  if (vec) {
    const float4 w = *reinterpret_cast<const float4*>(a);
    v[0] = w.x, v[1] = w.y, v[2] = w.z, v[3] = w.w;
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = u < n ? a[u] : 0.0f;
  }
}

__device__ __forceinline__ void store4(float* __restrict__ a, int n, bool vec,
                                       const float (&v)[4]) {
  if (vec) {
    *reinterpret_cast<float4*>(a) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (u < n) a[u] = v[u];
  }
}

// Read the epilogue's operands (n = the units of the four below H)
__device__ __forceinline__ void epilogue_load(const BwdStepArgs& p,
                                              long long m, int j, int n,
                                              EpIn& e) {
  const bool vec = p.vec && n == 4;
  const long long o = m * p.H + j;
  load4(p.dhz + o, n, vec, e.dhz);
  if (p.gn == nullptr) return;
  load4(p.hprev + o, n, vec, e.hp);
  load4(p.dhs + o, n, vec, e.ds);
  const float* gb = p.gn + m * 4 * p.H + j;
#pragma unroll
  for (int q = 0; q < 4; ++q) load4(gb + q * p.H, n, vec, e.pre[q]);
}

// The epilogue at units j..j+3 of row m from the whole product sums v of
// step t: the gradient carried out of t is c = d z + v; at the last step
// it is dh0, else step t''s gate gradients take it.
__device__ __forceinline__ void epilogue_store(const BwdStepArgs& p,
                                               long long m, int j, int n,
                                               const EpIn& e,
                                               const float (&v)[4]) {
  const bool vec = p.vec && n == 4;
  const long long o = m * p.H + j;
  float c[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) c[u] = e.dhz[u] + v[u];
  if (p.gn == nullptr) {
    store4(p.dh0 + o, n, vec, c);
    return;
  }
  float out[4][4], dz_out[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    float pre[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) pre[q] = e.pre[q][u];
    dz_out[u] = gate_grads(pre, e.hp[u], c[u] + e.ds[u]);
#pragma unroll
    for (int q = 0; q < 4; ++q) out[q][u] = pre[q];
  }
  float* gb = p.gn + m * 4 * p.H + j;
#pragma unroll
  for (int q = 0; q < 4; ++q) store4(gb + q * p.H, n, vec, out[q]);
  store4(p.dhz + o, n, vec, dz_out);
}

// One step of the sweep (see the note at the head): the BM x BN block of
// dh' of tile blockIdx.x / S, whose K this CTA shares with the S - 1
// others of its cluster (S = 1: no cluster, the whole K).
template <class C, int S>
__global__ void __launch_bounds__(C::NT, C::MIN_BLOCKS)
    bwd_step_kernel(const BwdStepArgs p) {
  constexpr int STAGE = stage_bytes<C, false, false>();
  extern __shared__ __align__(16) unsigned char smem[];
  // column blocks run fastest, so that the CTAs that read the same rows
  // of g[t] run together
  const int n_tn = (p.H + C::BN - 1) / C::BN;
  const int tile = blockIdx.x / S;
  MmaCtx c = {};
  c.m0 = static_cast<long long>(tile / n_tn) * C::BM;
  c.M = p.B;
  c.n0 = (tile % n_tn) * C::BN;
  c.N = p.H;
  // this CTA's run of K's tiles over both segments: contiguous, as even
  // as possible, none empty (step_split keeps S <= n_k)
  int rank = 0;
  if constexpr (S > 1) {
    rank = static_cast<int>(cg::this_cluster().block_rank());
  }
  const int nk0 = (p.seg[0].K + C::BK - 1) / C::BK;
  const int n_k = nk0 + (p.seg[1].K + C::BK - 1) / C::BK;
  const int kt0 = rank * n_k / S;
  const int n_it = (rank + 1) * n_k / S - kt0;

  auto issue = [&](int i) {
    unsigned char* st = smem + (i % C::STAGES) * STAGE;
    const int kt = kt0 + i;
    if (kt < nk0) {
      stage_a<C, float, false>(st, p.seg[0], c, kt * C::BK);
      stage_b<C, false, false>(st, p.seg[0], c, kt * C::BK);
    } else {
      stage_a<C, float, false>(st, p.seg[1], c, (kt - nk0) * C::BK);
      stage_b<C, false, false>(st, p.seg[1], c, (kt - nk0) * C::BK);
    }
  };

  float acc[C::MI][C::NI][4];
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < C::NI; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.0f;

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
    mma_stage<C, float, false, false>(smem + (i % C::STAGES) * STAGE, acc);
  }
  cp_async_wait<0>();

  // The block's sums go through shared memory, so that the epilogue reads
  // and writes runs of four units a thread. acc[mi][ni][2h + e] holds row
  // g + 8h of the warp's tile mi, column ni 8 + 2t + e of its tile
  // columns; the partial tile is [row][column] at pitch RP (8 mod 32: the
  // float2 stores of a half-warp hit 32 distinct banks), in the ring.
  constexpr int RP = C::BN + 8, RB = C::BM / S, G4 = C::BN / 4;
  static_assert(C::BM % S == 0, "the tile's rows divide over the ranks");
  static_assert(RP % 32 == 8, "conflict-free partial tile stores");
  static_assert(C::BM * RP * 4 <= C::STAGES * STAGE,
                "the partial tile fits in the ring");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / C::WARPS_N) * C::WM;
  const int wn = (warp % C::WARPS_N) * C::WN;
  float* red = reinterpret_cast<float*>(smem);
  __syncthreads();  // every warp is done with the ring
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < C::NI; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm + mi * 16 + g + h * 8;
        *reinterpret_cast<float2*>(red + row * RP + wn + ni * 8 + 2 * t) =
            make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
  const float* part[S];
  if constexpr (S > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every rank's partial tile written
#pragma unroll
    for (int r = 0; r < S; ++r) part[r] = cluster.map_shared_rank(red, r);
  } else {
    __syncthreads();
    part[0] = red;
  }
  // the rank's rows, four units a thread, two runs of them at once: their
  // operands are read before any sum is formed, so that the reads of the
  // epilogue are in flight together
  constexpr int BATCH = 2;
  for (int q0 = threadIdx.x; q0 < RB * G4; q0 += BATCH * C::NT) {
    EpIn in[BATCH];
    long long m[BATCH];
    int j[BATCH], n[BATCH], o[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int q = q0 + u * C::NT;
      const int row = rank * RB + q / G4, col = (q % G4) * 4;
      m[u] = c.m0 + row;
      j[u] = c.n0 + col;
      o[u] = row * RP + col;
      n[u] = q < RB * G4 && m[u] < p.B ? min(4, p.H - j[u]) : 0;
      if (n[u] > 0) epilogue_load(p, m[u], j[u], n[u], in[u]);
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      if (n[u] <= 0) continue;
      float4 v = *reinterpret_cast<const float4*>(part[0] + o[u]);
#pragma unroll
      for (int r = 1; r < S; ++r) {
        const float4 w = *reinterpret_cast<const float4*>(part[r] + o[u]);
        v.x += w.x, v.y += w.y, v.z += w.z, v.w += w.w;
      }
      const float sums[4] = {v.x, v.y, v.z, v.w};
      epilogue_store(p, m[u], j[u], n[u], in[u], sums);
    }
  }
  if constexpr (S > 1) {
    // no CTA leaves while a peer reads its partial tile
    cg::this_cluster().sync();
  }
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


// The weight gradients' row split: as many CTAs as fit in four waves of
// one MmaBig CTA on each SM, at most DW_MAX_SPLIT partials.
constexpr long long DW_CTAS = 4 * 132;
constexpr long long DW_MAX_SPLIT = 64;

// How a backward of n_steps x B rows splits its weight gradients' sums,
// from the shapes alone (so a run repeats its sums bit for bit), and the
// floats of the `part` scratch that the splits fill.
struct BwdPlan {
  int split_i, split_h;  // partials of [dWi; dbi] and [dWh; dbh]
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
  const long long a = pl.split_i * (F + 1LL) * 3 * H;
  const long long b = pl.split_h * (H + 1LL) * 3 * H;
  pl.part = a > b ? a : b;
  return pl;
}

// Sweep launches by cluster size since the last reset (gru_bwd_counts):
// [k] counts S = 2^k.
long long g_steps[5] = {0, 0, 0, 0, 0};

// The step kernel as the cluster launcher (gru_mma.cuh) takes it: at most
// 16 CTAs a cluster (the largest Hopper takes, a non-portable size)
struct BwdStep {
  using Args = BwdStepArgs;
  template <int S>
  static auto kernel() {
    return &bwd_step_kernel<MmaSmall, S>;
  }
  static constexpr int NT = MmaSmall::NT, MIN_BLOCKS = MmaSmall::MIN_BLOCKS;
  static constexpr int SMEM =
      MmaSmall::STAGES * stage_bytes<MmaSmall, false, false>();
  static constexpr int MAX_SPLIT = 16;
  static long long* counts() { return g_steps; }
};

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

  // 2. the sweep: the first step's gate gradients, then one launch a step
  // (bwd_step_kernel): step t's dgh Wh^T, split over K across a cluster
  // where the step has few tiles (step_split), and in its epilogue the next
  // step's gate gradients, or dh0 after the last step
  {
    const int t0 = reverse ? 0 : n_steps - 1;
    first_step_kernel<<<static_cast<unsigned>((BH + 255) / 256), 256, 0,
                        stream>>>(g + t0 * B * G4, hprev + t0 * BH,
                                  dhs + t0 * BH, dhz, B, H);
    RETURN_IF_LAUNCH_FAILED();
  }
  // the step's output tiles (BM rows x BN units) and its k-tiles over the
  // two runs of K
  const long long tiles =
      static_cast<long long>((B + MmaSmall::BM - 1) / MmaSmall::BM) *
      ((H + MmaSmall::BN - 1) / MmaSmall::BN);
  const int split = step_split<BwdStep>(
      tiles, (2 * H + MmaSmall::BK - 1) / MmaSmall::BK +
                 (H + MmaSmall::BK - 1) / MmaSmall::BK);
  BwdStepArgs sp = {};
  sp.dhz = dhz;
  sp.dh0 = dh;
  sp.B = B;
  sp.H = H;
  sp.vec = H % 4 == 0 && aligned16(g) && aligned16(hprev) &&
           aligned16(dhs) && aligned16(dhz) && aligned16(dh);
  for (int s = 0; s < n_steps; ++s) {
    const int t = reverse ? s : n_steps - 1 - s;
    const float* gt = g + t * B * G4;
    sp.seg[0] = f32_seg(gt, G4, 2 * H);
    set_b(sp.seg[0], wh, H3);
    sp.seg[1] = f32_seg(gt + 3 * H, G4, H);
    set_b(sp.seg[1], wh + 2 * H, H3);
    sp.gn = nullptr;
    if (s + 1 < n_steps) {
      const int tn = reverse ? t + 1 : t - 1;
      sp.gn = g + tn * B * G4;
      sp.hprev = hprev + tn * BH;
      sp.dhs = dhs + tn * BH;
    }
    RETURN_IF_FAILED(launch_step<BwdStep>(sp, tiles, split, stream));
  }

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

// The library's counts since the last reset: counts[0] and counts[1] the
// weight products on wgmma and on mma.sync, counts[2 + k] the sweep's step
// launches whose K was split over S = 2^k CTAs (k < 5); zeroed after the
// read when `reset`.
int gru_bwd_counts(long long* counts, int reset) {
  read_routes(counts, reset);
  for (int k = 0; k < 5; ++k) {
    counts[2 + k] = g_steps[k];
    if (reset) g_steps[k] = 0;
  }
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
