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
//
// Gate math (torch convention, pallas_gru.py:25-31), gate order (r, z, n):
//   r = sigmoid(x Wi_r + bi_r + h Wh_r + bh_r)
//   z = sigmoid(x Wi_z + bi_z + h Wh_z + bh_z)
//   n = tanh(x Wi_n + bi_n + r * (h Wh_n + bh_n))
//   h' = (1 - z) * n + z * h
//
// Unidirectional layer (gru_fwd): two phases, every product on the tensor
// cores (gru_mma.cuh: 3xTF32). x is any (T, B, F) view with a contiguous
// feature axis: the windowed layer passes the overlapping (n_win, B,
// win*C) view of its batch-major frames (ops/gru.py: _windows), so its
// window stream is never built.
//   1. Before the sweep, the input projection of all N = T B rows,
//      gi = x Wi + bi (T, B, 3H), as one product: x Wi does not depend on
//      the recurrence, so it leaves the step loop and runs at the rate of a
//      large product, on wgmma from Wi's image (written at the call's start
//      into the caller's wimg scratch) from GRU_WGMMA_MIN_ROWS rows on,
//      else on mma_gemm_kernel (gru_mma.cuh). A bf16 x (the frames) is
//      exact in TF32 and takes two passes, a float32 x three. gi is scratch
//      that the caller allocates (1.8 GB at fig_5 width) and frees after
//      the call.
//   2. The sweep: one launch of gru_step_mma_kernel a step, from the host
//      loop below. Every step needs all of h_{t-1}, so the launch boundary
//      is the grid-wide barrier. An output tile is h_{t-1} Wh for BM batch
//      rows and the r, z and n columns of BN/3 hidden units, K = H; the
//      gate math in the epilogue reads gi[t], bh and h_{t-1} and writes
//      h_t. bh is added there, to the product, as the plain version adds
//      it to h Wh. Where a step has few tiles (B = 64: 24 tiles of 132
//      SMs), one tile's K is split over a thread-block cluster of S CTAs
//      (step_split: S in {1, 2, 4, 8}, from the shape and the card alone,
//      so that a run repeats its sums bit for bit). CTA rank r multiplies
//      its contiguous run of K's tiles; each CTA then leaves its partial
//      tile in its own shared memory (the ring, free by then), and after a
//      cluster barrier rank r sums rows [r BM/S, (r+1) BM/S) of the S
//      partial tiles through distributed shared memory in rank order 0..S-1
//      and applies the gate math to them. No float atomics, no global
//      scratch, one launch a step. At S = 1 the CTA keeps the whole sum in
//      its registers and applies the gate math to it: the split's epilogue
//      at S = 1 (a cluster of 1) gives the same bits, but its step ran
//      7-22 % slower on an H100 at the S = 1 shapes of the benchmark's
//      cells (PERF.md, section 6).
// The three gates' columns. A CTA reads Wh's three column runs
// [g H + j0, g H + j0 + BN/3), g = r, z, n, where they lie, and places them
// in its shared-memory tile so that each warp's columns hold the r, z and
// n runs of the warp's own units side by side; the m16n8 tiles of one
// thread then hold all three gates of the same units. Nothing is permuted
// in device memory: Wh and gi keep the layout that the backward and the
// plain version read, and no call copies or reorders Wh (3 MB at H = 512).
//
// What bounds it. The projection is 2 N F 3H FLOPs and the recurrence
// 2 N H 3H, against O(N (F + H)) bytes: bound by operations, at 495/3
// TFLOP/s float32-equivalent (3xTF32), 495/2 for the projection of a bf16
// x. The gi stream (12 N H bytes) is written once and read once. A step is
// a small grid (ceil(B/BM) x ceil(H/(BN/3)) CTAs, 512 at fig_5 width's
// B = 2000, H = 512) that reads h_{t-1} and its slices of Wh from L2 each
// step; its latency, more than the tensor cores' rate, sets the sweep's
// pace (at B = 64, H = 768, one CTA's chain of 24 k-tiles, which the
// cluster split cuts to 3). The step's faster form, for later work: wgmma.
// A persistent kernel that keeps each CTA's slice of Wh in shared memory
// across steps and syncs only the CTAs that share rows of h was tried for
// the bidirectional layer at the seq2seq bench's shape, whose grid fills
// the card, and ran no faster than one launch a step (PERF.md, section 6).
//
// Bidirectional layer (gru_bifwd): the unidirectional layer twice, forward
// then reversed, each in its two phases, over the one x (its strides as
// given: the seq2seq encoder passes a (T, B, F) view of batch-major conv
// output) and one gi scratch (T, B, 3H) that the reversed pass overwrites
// once the forward sweep has read it (the stream orders them; 1.15 GB at
// the seq2seq bench's T = 191, B = 1000, H = 500). On the TPU the fused
// kernel put two independent recurrence products back to back on the one
// MXU. On Hopper one direction's step grid already fills the card (at
// B = 1000, H = 500: 16 x 16 = 256 CTAs against 264 slots of 2 per SM), so
// both directions in one grid a step (the direction as the grid's z) run
// in two waves and were measured slower than the two sweeps one after the
// other (PERF.md, section 6). The weights come as two pointer sets, not
// stacked arrays: the port keeps fwd{l} and bwd{l} as separate
// parameters, and stacking them at every call would copy them. What bounds
// it: 2 x 2 T B (F + H) 3H FLOPs at 495/3 TFLOP/s (3xTF32; the projection
// of a bf16 x at 495/2): 4.17 ms at the seq2seq bench's shape.

#include <cooperative_groups.h>

#include "gru_mma.cuh"
#include "gru_tile.cuh"

namespace {

namespace cg = cooperative_groups;

// The sweep's step tile, as MmaCfg<BM, BN, warps along M, warps along N,
// stages, CTAs per SM> with BN = 3 x the hidden units of a CTA: a warp
// owns BN / (3 x warps along N) units, whole m16n8 column tiles of each
// gate. The default, 64 rows x 32 units in 4 warps of 32 rows x 16 units,
// gives 32 x 16 = 512 CTAs a step at fig_5 width. `python
// tools/port_probes.py fwd` times other shapes (-DGRU_FWD_STEP=...).
#ifndef GRU_FWD_STEP
#define GRU_FWD_STEP 64, 96, 2, 2, 3, 2
#endif
using StepCfg = MmaCfg<GRU_FWD_STEP>;

// One step's operands: h = h_{t-1} (B, H) as the A segment, gi the step's
// (B, 3H) rows of x Wi + bi, hout the step's (B, H) rows of hs.
struct StepArgs {
  MmaSeg h;
  const float* wh;
  const float* bh;
  const float* gi;
  float* hout;
  int B, H;
  int wh_vec;  // every run of Wh's three column runs 16-byte aligned
};

// Stage rows [k0, k0 + BK) of the CTA's Wh columns: tile column j of warp
// column block w = j / WN is unit j0 + w WU + (j % WN) % WU of gate
// (j % WN) / WU, WU = WN / 3.
template <class C>
__device__ __forceinline__ void stage_wh(unsigned char* st,
                                         const StepArgs& p, int j0, int k0) {
  constexpr int WU = C::WN / 3;
  float* s = reinterpret_cast<float*>(st + a_bytes<C, false>());
  const long long H3 = 3LL * p.H;
  stage_tile<float, C::BK, C::BN, b_pitch<C, true>(), C::NT>(
      s, p.wh_vec, [&](int r, int j) {
        const int k = k0 + r;
        const int rem = j % C::WN;
        const int u = j0 + (j / C::WN) * WU + rem % WU;
        if (k >= p.H || u >= p.H) return Run{p.wh, 0};
        return Run{p.wh + k * H3 + (rem / WU) * p.H + u, p.H - u};
      });
}

// h_t of unit j of batch row m from its gates' sums ar, az, an of
// h_{t-1} Wh (the gate math; hprev = h_{t-1})
__device__ __forceinline__ void gate_out(const StepArgs& p,
                                         const float* __restrict__ hprev,
                                         long long m, int j, float ar,
                                         float az, float an) {
  const int H = p.H;
  const float* __restrict__ gi = p.gi + m * 3 * H;
  const float r = sigmoid_f32(gi[j] + (ar + p.bh[j]));
  const float z = sigmoid_f32(gi[H + j] + (az + p.bh[H + j]));
  const float n = tanhf(gi[2 * H + j] + r * (an + p.bh[2 * H + j]));
  const long long o = m * H + j;
  p.hout[o] = (1.0f - z) * n + z * hprev[o];
}

// One step of the sweep (see the note at the head): the BM rows and BN/3
// units of h_t of tile blockIdx.x / S, whose K this CTA shares with the
// S - 1 others of its cluster (S = 1: no cluster, the whole K).
template <class C, int S>
__global__ void __launch_bounds__(C::NT, C::MIN_BLOCKS)
    gru_step_mma_kernel(const StepArgs p) {
  static_assert(C::BN % 3 == 0 && C::WN % 24 == 0,
                "a warp owns whole m16n8 column tiles of each gate");
  static_assert(b_pitch<C, true>() % 16 == 4,
                "Wh tile pitch 4 mod 16: conflict-free fragment reads");
  constexpr int WU = C::WN / 3;
  constexpr int NU = WU / 8;  // column tiles of one gate in a warp
  constexpr int STAGE = stage_bytes<C, false, true>();
  extern __shared__ __align__(16) unsigned char smem[];
  // unit blocks run fastest, so that the CTAs that read the same rows of
  // h_{t-1} run together
  const int n_tu = (p.H + C::BN / 3 - 1) / (C::BN / 3);
  const int tile = blockIdx.x / S;
  MmaCtx c = {};
  c.m0 = static_cast<long long>(tile / n_tu) * C::BM;
  c.M = p.B;
  const int j0 = (tile % n_tu) * (C::BN / 3);
  // this CTA's run of K's tiles: contiguous, as even as possible, none
  // empty (step_split keeps S <= n_k)
  int rank = 0;
  if constexpr (S > 1) {
    rank = static_cast<int>(cg::this_cluster().block_rank());
  }
  const int n_k = (p.H + C::BK - 1) / C::BK;
  const int kt0 = rank * n_k / S;
  const int n_it = (rank + 1) * n_k / S - kt0;

  auto issue = [&](int i) {
    unsigned char* st = smem + (i % C::STAGES) * STAGE;
    stage_a<C, float, false>(st, p.h, c, (kt0 + i) * C::BK);
    stage_wh<C>(st, p, j0, (kt0 + i) * C::BK);
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
    mma_stage<C, float, false, true>(smem + (i % C::STAGES) * STAGE, acc);
  }
  cp_async_wait<0>();

  // acc[mi][g NU + nu] holds gate g of units wu + nu*8 + 2t + e, rows
  // g + 8h of the warp's tile mi
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / C::WARPS_N) * C::WM;
  const int wu = (warp % C::WARPS_N) * WU;  // from j0
  const float* __restrict__ hprev = static_cast<const float*>(p.h.a);
  if constexpr (S == 1) {
#pragma unroll
    for (int mi = 0; mi < C::MI; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long m = c.m0 + wm + mi * 16 + g + h * 8;
        if (m >= p.B) continue;
#pragma unroll
        for (int nu = 0; nu < NU; ++nu) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = j0 + wu + nu * 8 + 2 * t + e;
            if (j >= p.H) continue;
            const int q = 2 * h + e;
            gate_out(p, hprev, m, j, acc[mi][nu][q], acc[mi][NU + nu][q],
                     acc[mi][2 * NU + nu][q]);
          }
        }
      }
    }
  } else {
    // the partial tile, [row][gate U + unit] at pitch RP (8 mod 32: the
    // float2 stores of a half-warp hit 32 distinct banks), in the ring
    constexpr int U = C::BN / 3, RP = C::BN + 8, RB = C::BM / S;
    static_assert(C::BM % S == 0, "the tile's rows divide over the ranks");
    static_assert(C::BM * RP * 4 <= C::STAGES * STAGE,
                  "the partial tile fits in the ring");
    float* red = reinterpret_cast<float*>(smem);
    cg::cluster_group cluster = cg::this_cluster();
    __syncthreads();  // every warp is done with the ring
#pragma unroll
    for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < C::NI; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = wm + mi * 16 + g + h * 8;
          const int col = (ni / NU) * U + wu + (ni % NU) * 8 + 2 * t;
          *reinterpret_cast<float2*>(red + row * RP + col) =
              make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
        }
    cluster.sync();  // every rank's partial tile written
    const float* part[S];
#pragma unroll
    for (int r = 0; r < S; ++r) part[r] = cluster.map_shared_rank(red, r);
    // rank's rows, one row a warp at a time (U = 32 units: a warp's loads
    // of a gate are one contiguous run of every rank's tile)
    for (int i = threadIdx.x; i < RB * U; i += C::NT) {
      const int row = rank * RB + i / U, u = i % U;
      const long long m = c.m0 + row;
      const int j = j0 + u;
      if (m >= p.B || j >= p.H) continue;
      float a[3];
#pragma unroll
      for (int gate = 0; gate < 3; ++gate) {
        const int o = row * RP + gate * U + u;
        float v = part[0][o];
#pragma unroll
        for (int r = 1; r < S; ++r) v += part[r][o];
        a[gate] = v;
      }
      gate_out(p, hprev, m, j, a[0], a[1], a[2]);
    }
    cluster.sync();  // no CTA leaves while a peer reads its partial tile
  }
}

// Step launches by cluster size since the last reset (gru_fwd_counts):
// [k] counts S = 2^k.
long long g_steps[4] = {0, 0, 0, 0};

// The step kernel as the cluster launcher (gru_mma.cuh) takes it: at most
// 8 CTAs a cluster
struct FwdStep {
  using Args = StepArgs;
  template <int S>
  static auto kernel() {
    return &gru_step_mma_kernel<StepCfg, S>;
  }
  static constexpr int NT = StepCfg::NT, MIN_BLOCKS = StepCfg::MIN_BLOCKS;
  static constexpr int SMEM =
      StepCfg::STAGES * stage_bytes<StepCfg, false, true>();
  static constexpr int MAX_SPLIT = 8;
  static long long* counts() { return g_steps; }
};

// The step's output tiles: BM rows x BN/3 units
long long step_tiles(int B, int H) {
  const int units = StepCfg::BN / 3;
  return static_cast<long long>((B + StepCfg::BM - 1) / StepCfg::BM) *
         ((H + units - 1) / units);
}

// Wi's image (F x 3H, runs [0, 2H) and [2H, 3H), as the backward cuts it)
// in the scratch wimg
WImage wi_image(float* wimg, int F, int H) {
  return wimage(wimg, F, 3 * H, 2 * H);
}

// The unidirectional layer over x (n_steps, B, F) of type T with strides
// (sx_t, sx_b, 1): 1. gi = x Wi + bi over all rows; 2. the sweep, step s
// at time t = s (or n_steps-1-s when reverse), its h_{t-1} h0 at s == 0,
// else the hs row written by the step before, every step split over K
// alike (step_split). gi (n_steps, B, 3H) is scratch, and so is wimg
// (gru_fwd_wimg floats; null below the wgmma route's rows). Returns the
// first launch error, else cudaGetLastError().
template <typename T>
int run_layer(const void* x, long long sx_t, long long sx_b, const float* h0,
              const float* wi, const float* bi, const float* wh,
              const float* bh, float* hs, float* gi, float* wimg,
              int n_steps, int B, int F, int H, int reverse,
              cudaStream_t stream) {
  const long long H3 = 3LL * H;
  const long long BH = static_cast<long long>(B) * H;
  {
    const long long N = static_cast<long long>(n_steps) * B;
    const bool on_wgmma = wimg != nullptr && wgmma_rows(N);
    const WImage im = wi_image(wimg, F, H);
    if (on_wgmma) RETURN_IF_FAILED(presplit(im, wi, H3, false, stream));
    MmaArgs p = out_args(gi, H3, 0, N, 3 * H);
    p.seg[0] = x_seg<T>(static_cast<const T*>(x), sx_t, sx_b, B, F);
    set_b(p.seg[0], wi, H3);
    p.bias0 = bi;
    RETURN_IF_FAILED((weight_product<T, true>(p, &im, nullptr, 0, on_wgmma,
                                              stream)));
  }
  StepArgs p = {};
  p.wh = wh;
  p.bh = bh;
  p.B = B;
  p.H = H;
  p.wh_vec = aligned16(wh) && H % 4 == 0;
  const long long tiles = step_tiles(B, H);
  const int split =
      step_split<FwdStep>(tiles, (H + StepCfg::BK - 1) / StepCfg::BK);
  for (int s = 0; s < n_steps; ++s) {
    const int t = reverse ? n_steps - 1 - s : s;
    p.h = f32_seg(s == 0 ? h0 : hs + (reverse ? t + 1 : t - 1) * BH, H, H);
    p.gi = gi + t * B * H3;
    p.hout = hs + t * BH;
    RETURN_IF_FAILED(launch_step<FwdStep>(p, tiles, split, stream));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace


extern "C" {

// The floats of the wimg scratch that a forward of n_rows = T B rows, F
// inputs and H units needs, into *n: 0 where its projection takes
// mma.sync (then wimg may be null).
int gru_fwd_wimg(long long n_rows, int F, int H, long long* n) {
  *n = wgmma_rows(n_rows) ? wimage_floats(wi_image(nullptr, F, H)) : 0;
  return 0;
}

// The library's counts since the last reset: counts[0] and counts[1] the
// weight products on wgmma and on mma.sync, counts[2 + k] the step
// launches whose K was split over S = 2^k CTAs (k < 4); zeroed after the
// read when `reset`.
int gru_fwd_counts(long long* counts, int reset) {
  read_routes(counts, reset);
  for (int k = 0; k < 4; ++k) {
    counts[2 + k] = g_steps[k];
    if (reset) g_steps[k] = 0;
  }
  return 0;
}

// GRU layer over x (T, B, F), bf16 where x_bf16 else float32, with
// strides (sx_t, sx_b, 1): hs (T, B, H) float32, contiguous; gi
// (T, B, 3H) and wimg (gru_fwd_wimg floats) float32 scratch.
int gru_fwd(const void* x, long long sx_t, long long sx_b, int x_bf16,
            const float* h0, const float* wi, const float* bi,
            const float* wh, const float* bh, float* hs, float* gi,
            float* wimg, int T, int B, int F, int H, int reverse,
            void* stream) {
  const auto run = x_bf16 ? &run_layer<__nv_bfloat16> : &run_layer<float>;
  return run(x, sx_t, sx_b, h0, wi, bi, wh, bh, hs, gi, wimg, T, B, F, H,
             reverse, static_cast<cudaStream_t>(stream));
}

// Bidirectional GRU layer over x as gru_fwd's, one weight set per
// direction: hs_f and hs_b (T, B, H) float32, contiguous, both in the
// original time order; gi and wimg as gru_fwd's, each used by one
// direction after the other.
int gru_bifwd(const void* x, long long sx_t, long long sx_b, int x_bf16,
              const float* h0_f, const float* wi_f, const float* bi_f,
              const float* wh_f, const float* bh_f, const float* h0_b,
              const float* wi_b, const float* bi_b, const float* wh_b,
              const float* bh_b, float* hs_f, float* hs_b, float* gi,
              float* wimg, int T, int B, int F, int H, void* stream) {
  const auto run = x_bf16 ? &run_layer<__nv_bfloat16> : &run_layer<float>;
  const auto s = static_cast<cudaStream_t>(stream);
  RETURN_IF_FAILED(run(x, sx_t, sx_b, h0_f, wi_f, bi_f, wh_f, bh_f, hs_f, gi,
                       wimg, T, B, F, H, 0, s));
  return run(x, sx_t, sx_b, h0_b, wi_b, bi_b, wh_b, bh_b, hs_b, gi, wimg, T,
             B, F, H, 1, s);
}

}  // extern "C"
