"""The operand split of the GRU kernels' tensor-core products, emulated in
numpy on the CPU.

``csrc/gru_mma.cuh`` multiplies float32 operands on TF32 tensor cores as
3xTF32: each value v is split into hi = tf32(v) and lo = tf32(v - hi) (round
to nearest, ties away, at 10 mantissa bits: ``cvt.rna.tf32.f32``), and
a b = lo_a hi_b + hi_a lo_b + hi_a hi_b; a bf16 operand is exact in TF32, so
its lo is 0. Each 32-deep reduction tile is summed apart and added to a
float32 accumulator; a long reduction is cut into fixed partials that are
summed in order (the weight gradients). This file emulates that on
numpy-seeded data at the reductions the kernels run: a narrow slice of the
fig_5 dW sum (n_win * B = 147 * 2000 = 294,000 rows, split into 6
partials), the recurrent dh Wh^T (K = 3H = 1536) and the gate recompute
(K = F + H = 1352). Against float64, the split product must stay 10x inside
the 1e-3 that chip_smoke.py holds the gradients to (GRAD_RTOL), and the
one-pass TF32 and bf16 products, which it replaces, are shown not to. The
forward (csrc/gru_fwd.cu) is emulated over 120 steps of its recurrence
against the 1e-4 that hs is held to, and over the seq2seq encoder's 191
steps at H = 500 (gru_bifwd's shape there); its step kernel's column map
is mirrored and checked, and so are its split of K over a cluster (the
ranks' runs, the partial tile's layout, the rule that picks the split) and
the split's sums over 120 steps at H = 768. The backward sweep's step
(csrc/gru_bwd.cu) is mirrored likewise: the rule that picks its cluster,
the ranks' runs over the gapped K = 3H, the one owner of each (b, j) in
its fused epilogue, and the split sweep's dh0 and dWh over 120 steps at
B = 64, H = 768 against float64.
"""

import numpy as np
import pytest

GRAD_RTOL = 1e-3
TILE = 32


def _round_bits(v, drop: int):
    """float32 v rounded to nearest, ties away from zero, with the low
    ``drop`` mantissa bits cleared (the sign is its own bit, so adding half
    a unit to the magnitude's bits rounds both signs alike)."""
    u = np.asarray(v, np.float32).view(np.uint32).astype(np.uint64)
    u = ((u + (1 << (drop - 1))) >> drop) << drop
    return u.astype(np.uint32).view(np.float32)


def tf32(v):
    return _round_bits(v, 13)


def bf16(v):
    return _round_bits(v, 16)


def split(v):
    hi = tf32(v)
    return hi, tf32(v - hi)


def _tiled(a, b, n_parts: int = 1):
    """sum_k a[:, k] b[k, :] as the kernel orders it: float32 sums of
    32-deep tiles, added tile by tile into float32 partials of ~K/n_parts
    rows, the partials added in order."""
    M, K = a.shape
    n_tiles = -(-K // TILE)
    pad = n_tiles * TILE - K
    a = np.pad(a, ((0, 0), (0, pad))).reshape(M, n_tiles, TILE)
    b = np.pad(b, ((0, pad), (0, 0))).reshape(n_tiles, TILE, -1)
    tiles = np.matmul(a.transpose(1, 0, 2), b)  # float32 per tile
    per = -(-n_tiles // n_parts)
    out = np.zeros(tiles.shape[1:], np.float32)
    for p in range(0, n_tiles, per):
        out += np.cumsum(tiles[p:p + per], axis=0, dtype=np.float32)[-1]
    return out


def split_product(a, b, n_parts: int = 1, a_exact: bool = False,
                  b_split=None):
    """The kernel's 3xTF32 product (2 products when a is exact in TF32);
    ``b_split`` is b's (hi, lo) where the caller keeps it."""
    ah, al = (tf32(a), None) if a_exact else split(a)
    bh, bl = split(b) if b_split is None else b_split
    out = _tiled(ah, bh, n_parts) + _tiled(ah, bl, n_parts)
    if al is not None:
        out += _tiled(al, bh, n_parts)
    return out


def one_pass(a, b, rnd, n_parts: int = 1):
    return _tiled(rnd(a), rnd(b), n_parts)


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


# (reduction, M, K, N, partials, a's dtype): A is (M, K), B (K, N)
CASES = {
    "dwi_fig5_f32": (8, 294_000, 8, 6, np.float32),
    "dwi_fig5_bf16_frames": (8, 294_000, 8, 6, "bf16"),
    "dh_recurrent": (64, 1536, 64, 1, np.float32),
    "gate_recompute": (64, 1352, 64, 1, np.float32),
    "gate_recompute_bf16_x": (64, 840, 64, 1, "bf16"),
}


def _operands(name):
    M, K, N, parts, dt = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    a = rng.uniform(-1, 1, size=(M, K)).astype(np.float32)
    if dt == "bf16":
        a = bf16(a)
    b = (rng.normal(size=(K, N)) * 1e-3).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    return a, b, want, parts, dt == "bf16"


@pytest.mark.parametrize("name", sorted(CASES))
def test_split_product_is_float32_class(name):
    a, b, want, parts, exact = _operands(name)
    err = _rel(split_product(a, b, parts, a_exact=exact), want)
    f32 = _rel(_tiled(a, b, parts), want)
    print(f"{name}: 3xTF32 {err:.2e}, float32 {f32:.2e}")
    assert err <= GRAD_RTOL / 10
    # within a few times plain float32 arithmetic in the same order
    assert err <= 4 * f32 + 1e-7


@pytest.mark.parametrize("name", sorted(CASES))
def test_one_pass_products_are_not(name):
    """What the split buys: one TF32 pass errs ~3e-4 of the largest output
    (not 10x inside GRAD_RTOL), one bf16 pass ~2e-3 (outside it)."""
    a, b, want, parts, _ = _operands(name)
    err_tf32 = _rel(one_pass(a, b, tf32, parts), want)
    err_bf16 = _rel(one_pass(a, b, bf16, parts), want)
    err_split = _rel(split_product(a, b, parts), want)
    print(f"{name}: one TF32 pass {err_tf32:.2e}, one bf16 pass "
          f"{err_bf16:.2e}, 3xTF32 {err_split:.2e}")
    assert err_tf32 > GRAD_RTOL / 10
    assert err_bf16 > err_tf32
    assert err_tf32 > 100 * err_split


@pytest.mark.parametrize("v", [1.0, -1.0, 3.0e-3, -7.25e5, 1.0 + 2.0 ** -11,
                               1.0 + 3 * 2.0 ** -11, -(1.0 + 2.0 ** -11)])
def test_tf32_rounds_to_nearest_ties_away(v):
    """cvt.rna.tf32.f32 on single values: ties (exactly half a TF32 unit)
    go away from zero, and hi + lo recovers v to float32's own bits."""
    x = np.float32(v)
    hi, lo = split(np.array([x]))
    ulp = np.float32(2.0 ** (np.floor(np.log2(abs(x))) - 10))
    assert abs(float(hi[0]) - float(x)) <= float(ulp) / 2
    if abs(float(x) / float(ulp) - np.round(float(x) / float(ulp))) == 0.5:
        assert abs(float(hi[0])) > abs(float(x))
    assert float(hi[0]) + float(lo[0]) == pytest.approx(float(x), rel=5e-7)


# ---------------------------------------------------------------------------
# the forward (csrc/gru_fwd.cu): 3xTF32 input projection before the sweep,
# 3xTF32 h Wh in every step, the gate math in float32
# ---------------------------------------------------------------------------

KERNEL_ATOL = 1e-4  # chip_smoke.py: kernel vs plain on hs


def _sigmoid(v):
    return 1.0 / (1.0 + np.exp(-v))


def _gru_operands(T, B, F, H, x_bf16, seed=0):
    """chip_smoke.py's scales: x uniform in [-1, 1), Wi ~ N/sqrt(F), Wh ~
    N/sqrt(H), biases 0.1 N, h0 0.3 N."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (T, B, F)).astype(np.float32)
    if x_bf16:
        x = bf16(x)
    return (x, (rng.normal(size=(B, H)) * 0.3).astype(np.float32),
            (rng.normal(size=(F, 3 * H)) / np.sqrt(F)).astype(np.float32),
            (rng.normal(size=3 * H) * 0.1).astype(np.float32),
            (rng.normal(size=(H, 3 * H)) / np.sqrt(H)).astype(np.float32),
            (rng.normal(size=3 * H) * 0.1).astype(np.float32))


def forward_recurrence(x, h0, wi, bi, wh, bh, product, x_exact=False):
    """hs of the GRU over x (T, B, F) with both products taken by
    ``product(a, b, a_exact)``: gi = x Wi + bi for all rows first, then a
    step's r = sigmoid(gi_r + (h Wh_r + bh_r)), ... in the working type of
    the product's result (float64 for the reference)."""
    T, B, F = x.shape
    H = wh.shape[0]
    gi = (product(x.reshape(-1, F), wi, x_exact) + bi).reshape(T, B, 3 * H)
    h = h0.astype(gi.dtype)
    hs = []
    for t in range(T):
        gh = product(h, wh, False) + bh
        g = gi[t]
        r = _sigmoid(g[:, :H] + gh[:, :H])
        z = _sigmoid(g[:, H:2 * H] + gh[:, H:2 * H])
        n = np.tanh(g[:, 2 * H:] + r * gh[:, 2 * H:])
        h = ((1 - z) * n + z * h).astype(gi.dtype)
        hs.append(h)
    return np.stack(hs)


def _f64(a, b, _):
    return a.astype(np.float64) @ b.astype(np.float64)


def _3xtf32(a, b, a_exact):
    return split_product(a, b, a_exact=a_exact)


def _1xtf32(a, b, _):
    return one_pass(a, b, tf32)


@pytest.mark.parametrize("x_bf16", [False, True])
@pytest.mark.parametrize("H", [64, 128])
def test_forward_split_recurrence_stays_within_kernel_atol(H, x_bf16):
    """120 steps of the forward with both products 3xTF32 (the projection
    of bf16 x 2xTF32): within 1e-4 of float64 on every h_t, 10x inside."""
    ops = _gru_operands(120, 16, 64, H, x_bf16)
    want = forward_recurrence(*ops, _f64)
    got = forward_recurrence(*ops, _3xtf32, x_exact=x_bf16)
    err = float(np.abs(got - want).max())
    print(f"H={H} bf16 x={x_bf16}: 3xTF32 max |hs - hs64| {err:.2e}")
    assert err <= KERNEL_ATOL / 10


@pytest.mark.parametrize("x_bf16", [False, True])
@pytest.mark.parametrize("H", [64, 128])
def test_forward_one_pass_recurrence_drifts_past_kernel_atol(H, x_bf16):
    """What the split buys in the forward: with one TF32 pass per product
    the same 120 steps drift past the 1e-4 that hs is held to."""
    ops = _gru_operands(120, 16, 64, H, x_bf16)
    want = forward_recurrence(*ops, _f64)
    err = float(np.abs(forward_recurrence(*ops, _1xtf32) - want).max())
    print(f"H={H} bf16 x={x_bf16}: one TF32 pass max |hs - hs64| {err:.2e}")
    assert err > KERNEL_ATOL


@pytest.mark.parametrize("x_bf16", [False, True])
def test_seq2seq_encoder_recurrence_stays_within_kernel_atol(x_bf16):
    """The seq2seq encoder's sweep at its own length and width (T = 191
    steps, F = 100, H = 500; B = 4 rows): gru_bifwd takes every product
    3xTF32, as gru_fwd does, and each direction is this recurrence (the
    reverse one over the reversed x). Within 1e-4 of float64 on every h_t,
    10x inside."""
    ops = _gru_operands(191, 4, 100, 500, x_bf16, seed=5)
    splits = {}

    def product(a, b, a_exact):
        if id(b) not in splits:  # Wi and Wh: split once, as they stay put
            splits[id(b)] = split(b)
        return split_product(a, b, a_exact=a_exact, b_split=splits[id(b)])

    want = forward_recurrence(*ops, _f64)
    got = forward_recurrence(*ops, product, x_exact=x_bf16)
    err = float(np.abs(got - want).max())
    print(f"T=191 H=500 bf16 x={x_bf16}: 3xTF32 max |hs - hs64| {err:.2e}")
    assert err <= KERNEL_ATOL / 10


# The step kernel's column map (gru_fwd.cu: stage_wh and the epilogue of
# gru_step_mma_kernel), mirrored: a CTA's tile holds, for each warp column
# block, the r, z and n runs of the warp's units side by side.

def _step_tiles():
    """The default GRU_FWD_STEP of gru_fwd.cu and the probe's variants,
    each as (BM, BN, warps along M, warps along N, stages, CTAs per SM)."""
    import importlib.util
    import re
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    src = (root / "cross_patient_speech_decoding_tpu_torch" / "ops" / "csrc"
           / "gru_fwd.cu").read_text()
    tiles = {"default": re.search(r"^#define GRU_FWD_STEP (.+)$", src,
                                  re.M).group(1)}
    spec = importlib.util.spec_from_file_location(
        "port_probes", root / "tools" / "port_probes.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for name, defines in mod.FWD_VARIANTS.items():
        for d in defines:
            if d.startswith("GRU_FWD_STEP="):
                tiles[name] = d.split("=", 1)[1]
    return {k: tuple(int(v) for v in t.split(",")) for k, t in tiles.items()}


STEP_TILES = _step_tiles()


def tile_column(j, j0, H, BN, warps_n):
    """stage_wh: the Wh column (gate H + unit) of tile column j in the CTA
    whose units start at j0; None past the last unit."""
    WN = BN // warps_n
    WU = WN // 3
    rem = j % WN
    u = j0 + (j // WN) * WU + rem % WU
    return None if u >= H else (rem // WU) * H + u


def thread_columns(H, BN, warps_n):
    """The epilogue: for each unit j, the Wh columns whose products the
    thread that writes h_t[:, j] holds as gates r, z and n (acc[mi][g NU +
    nu][2h + e], tile column wn WN + (g NU + nu) 8 + 2t + e)."""
    WN = BN // warps_n
    WU, NU = WN // 3, WN // 24
    cols = {}
    for j0 in range(0, H, BN // 3):
        for wn in range(warps_n):
            for t in range(4):
                for nu in range(NU):
                    for e in range(2):
                        j = j0 + wn * WU + nu * 8 + 2 * t + e
                        if j < H:
                            cols[j] = [tile_column(
                                wn * WN + (g * NU + nu) * 8 + 2 * t + e, j0,
                                H, BN, warps_n) for g in range(3)]
    return cols


@pytest.mark.parametrize("H", [1, 50, 97, 500, 512])
@pytest.mark.parametrize("tile", sorted(STEP_TILES))
def test_step_tiles_cover_every_column_once(tile, H):
    BM, BN, warps_m, warps_n, stages, ctas = STEP_TILES[tile]
    WN = BN // warps_n
    assert BN % 3 == 0 and WN % 24 == 0 and (BN + 4) % 16 == 4
    seen = [tile_column(j, j0, H, BN, warps_n)
            for j0 in range(0, H, BN // 3) for j in range(BN)]
    seen = [c for c in seen if c is not None]
    assert sorted(seen) == list(range(3 * H))
    # and a thread holds r, z and n of the unit it writes
    cols = thread_columns(H, BN, warps_n)
    assert sorted(cols) == list(range(H))
    assert all(c == [j, H + j, 2 * H + j] for j, c in cols.items())


@pytest.mark.parametrize("tile", sorted(STEP_TILES))
def test_gate_math_on_the_tile_layout_matches_plain(tile):
    """Take each step's products in the tile layout (h Wh's columns as the
    tiles hold them), run the plain gate math from there, write h_t back by
    unit: gru_layer_plain's hs, bit for bit."""
    import torch

    from cross_patient_speech_decoding_tpu_torch.ops import gru

    _, BN, _, warps_n, _, _ = STEP_TILES[tile]
    T, B, F, H = 4, 5, 7, 50
    x, h0, wi, bi, wh, bh = (torch.from_numpy(a) for a in _gru_operands(
        T, B, F, H, False, seed=3))
    cols = thread_columns(H, BN, warps_n)
    tiles = [[tile_column(j, j0, H, BN, warps_n) for j in range(BN)]
             for j0 in range(0, H, BN // 3)]
    # the layout: a (B, tiles x BN) product, a thread's three columns in it
    flat = [c for t_ in tiles for c in t_]
    where = {c: i for i, c in enumerate(flat) if c is not None}
    idx = [torch.tensor([where[cols[j][g]] for j in range(H)])
           for g in range(3)]
    h = h0
    hs = torch.empty((T, B, H))
    for t in range(T):
        gi = x[t] @ wi + bi
        full = h @ wh + bh
        in_tiles = torch.stack([full[:, c] if c is not None
                                else torch.zeros(B) for c in flat], 1)
        r = torch.sigmoid(gi[:, :H] + in_tiles[:, idx[0]])
        z = torch.sigmoid(gi[:, H:2 * H] + in_tiles[:, idx[1]])
        n = torch.tanh(gi[:, 2 * H:] + r * in_tiles[:, idx[2]])
        h = (1.0 - z) * n + z * h
        hs[t] = h
    assert torch.equal(hs, gru.gru_layer_plain(x, h0, wi, bi, wh, bh))


# ---------------------------------------------------------------------------
# the step kernel's split of K over a cluster (gru_mma.cuh: step_split;
# gru_step_mma_kernel's S > 1 epilogue), mirrored: rank r multiplies its
# run of K's tiles, leaves its partial tile as [row][gate U + unit], and
# sums rows [r BM/S, (r+1) BM/S) of every rank's tile in rank order
# ---------------------------------------------------------------------------

SPLITS = (1, 2, 4, 8)
MAX_SPLIT = 8  # gru_fwd.cu: FwdStep::MAX_SPLIT
H100_SMS = 132  # the H100 SXM's SMs (the card test pins the rule as built)


def step_runs(n_k: int, S: int):
    """The k-tiles [kt0, kt1) of each rank."""
    return [(r * n_k // S, (r + 1) * n_k // S) for r in range(S)]


def step_split(B, H, tile=STEP_TILES["default"], sms=H100_SMS,
               max_clusters=None):
    """step_split on a card of ``sms`` SMs whose clusters of S all fit at
    once unless ``max_clusters[S]`` says otherwise."""
    BM, BN, _, _, _, ctas = tile
    tiles = -(-B // BM) * -(-H // (BN // 3))
    n_k = -(-H // TILE)
    for s in (8, 4, 2):
        if (s <= MAX_SPLIT and s <= n_k and tiles * s <= ctas * sms
                and tiles <= (max_clusters or {}).get(s, tiles)):
            return s
    return 1


# (B, H, S): b2t (B 64, H 768: 24 tiles), fig5 train (512 x 512: 128),
# seq2seq (1,224 x 500: 320), eval (2,000 x 512: 512), the stream (1 x
# 512: 16), conv_rnn (1,073 x 128: 68 tiles), one k-tile (H 32)
@pytest.mark.parametrize("B,H,S", [(64, 768, 8), (512, 512, 2),
                                   (1224, 500, 1), (2000, 512, 1),
                                   (1, 512, 8), (1073, 128, 2), (64, 32, 1)])
def test_step_split_of_the_cells_shapes(B, H, S):
    assert step_split(B, H) == S


def test_step_split_steps_down_where_the_clusters_do_not_fit():
    assert step_split(64, 768, max_clusters={8: 23, 4: 24}) == 4
    assert step_split(64, 768, max_clusters={8: 0, 4: 0, 2: 0}) == 1


@pytest.mark.parametrize("H,S", [(H, S) for H in (8, 50, 97, 200, 500, 512,
                                                  768)
                                  for S in SPLITS if S <= -(-H // TILE)])
def test_step_runs_cover_k_once(H, S):
    """Contiguous runs in rank order, none empty, sizes within one (S is
    at most the k-tiles: step_split keeps it so)."""
    n_k = -(-H // TILE)
    runs = step_runs(n_k, S)
    assert runs[0][0] == 0 and runs[-1][1] == n_k
    assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
    sizes = [b - a for a, b in runs]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("tile,S", [(k, S) for k in sorted(STEP_TILES)
                                    for S in SPLITS[1:]
                                    if STEP_TILES[k][0] % S == 0])
def test_partial_tile_holds_each_gate_and_unit_once(tile, S):
    """The float2 stores of every thread's acc[mi][ni][2h + e] fill the
    partial tile once, gate g of local unit u at column g U + u (the Wh
    column that the tile's column map gives that product), and the ranks'
    rows cover the tile once; the default's stores are free of bank
    conflicts (pitch 8 mod 32)."""
    BM, BN, warps_m, warps_n, _, _ = STEP_TILES[tile]
    WM, WN = BM // warps_m, BN // warps_n
    WU, U, RP = WN // 3, BN // 3, BN + 8
    NU, MI, NI = WU // 8, WM // 16, WN // 8
    H = 3 * U  # one tile of units, every column in range
    seen = {}
    for warp in range(warps_m * warps_n):
        wm, wn = (warp // warps_n) * WM, warp % warps_n
        for mi in range(MI):
            for ni in range(NI):
                for h in range(2):
                    banks = []
                    for lane in range(32):
                        g, t = lane >> 2, lane & 3
                        row = wm + mi * 16 + g + h * 8
                        col = (ni // NU) * U + wn * WU + (ni % NU) * 8 + 2 * t
                        banks.append((row * RP + col) % 32)
                        for e in range(2):
                            wh_col = tile_column(wn * WN + ni * 8 + 2 * t + e,
                                                 0, H, BN, warps_n)
                            seen[(row, col + e)] = wh_col
                    if tile == "default":
                        for half in (banks[:16], banks[16:]):
                            words = sorted(b + e for b in half
                                           for e in range(2))
                            assert words == list(range(32))
    assert sorted(seen) == [(r, c) for r in range(BM) for c in range(BN)]
    assert all(wh == (c // U) * H + c % U for (_, c), wh in seen.items())
    rows = [rank * (BM // S) + i for rank in range(S)
            for i in range(BM // S)]
    assert rows == list(range(BM))


def _split_step_product(S):
    """h Wh as the split kernel sums it: each rank's run of 32-deep tiles
    added into its float32 partial from 0, the partials added in rank
    order (S = 1: the unsplit kernel)."""
    cache = {}

    def product(a, b, a_exact):
        if b.shape[0] != b.shape[1] // 3:  # x Wi: the projection, unsplit
            return split_product(a, b, a_exact=a_exact)
        if id(b) not in cache:
            cache[id(b)] = split(b)
        bh, bl = cache[id(b)]
        ah, al = split(a)
        n_k = -(-a.shape[1] // TILE)
        out = None
        for kt0, kt1 in step_runs(n_k, S):
            k0, k1 = kt0 * TILE, min(kt1 * TILE, a.shape[1])
            part = (_tiled(ah[:, k0:k1], bh[k0:k1])
                    + _tiled(ah[:, k0:k1], bl[k0:k1])
                    + _tiled(al[:, k0:k1], bh[k0:k1]))
            out = part if out is None else out + part
        return out

    return product


@pytest.mark.parametrize("S", [1, 8])
def test_split_step_recurrence_stays_within_kernel_atol(S):
    """120 steps at the b2t width (H = 768, 24 k-tiles; B = 4 rows) with
    the step product split over S ranks: within 1e-4 of float64 on every
    h_t, 10x inside, as the unsplit sum."""
    ops = _gru_operands(120, 4, 64, 768, True, seed=6)
    want = forward_recurrence(*ops, _f64)
    got = forward_recurrence(*ops, _split_step_product(S), x_exact=True)
    err = float(np.abs(got - want).max())
    print(f"H=768 S={S}: max |hs - hs64| {err:.2e}")
    assert err <= KERNEL_ATOL / 10


# ---------------------------------------------------------------------------
# the wgmma route of the weight products (csrc/gru_mma.cuh): the weight's
# hi and lo planes written once a call into an image, a 32-deep stage
# summed into `part` from 0 in k8 steps (lo_a hi_b, hi_a lo_b, hi_a hi_b
# each), part added to the accumulator in float32
# ---------------------------------------------------------------------------


def _wg_constants():
    """BN, BK of wgmma_gemm_kernel's tiles, from the header."""
    import re
    from pathlib import Path

    src = (Path(__file__).resolve().parents[1]
           / "cross_patient_speech_decoding_tpu_torch" / "ops" / "csrc"
           / "gru_mma.cuh").read_text()
    m = re.search(r"constexpr int BM = (\d+), BN = (\d+), BK = (\d+),", src)
    return int(m.group(2)), int(m.group(3))


WG_BN, WG_BK = _wg_constants()


def _rz(v):
    """float64 values to float32, rounded toward zero (the tensor cores'
    sums)."""
    r = v.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(v)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def image_index(K: int, n_cols: int, c_split: int):
    """presplit_kernel's map, mirrored: for every float of one plane of
    the image, the weight element (k, c) it holds, or (-1, -1) for the
    zero padding. Returns (k, c) arrays in image order."""
    nb0 = -(-c_split // WG_BN)
    nb1 = -(-(n_cols - c_split) // WG_BN)
    nkt = -(-K // WG_BK)
    plane = WG_BK * WG_BN
    e = np.arange(plane)
    cm, r, q = e // 32, (e // 4) % 8, e % 4
    kc, j = cm // (WG_BN // 8), (cm % (WG_BN // 8)) * 8 + r
    slot = (kc % 2) * 4 + q
    k_in = (kc // 2) * 8 + np.where(slot < 4, 2 * slot, 2 * (slot - 4) + 1)
    ks, cs = [], []
    for b in range(nb0 + nb1):
        first = b < nb0
        c = (b * WG_BN if first else c_split + (b - nb0) * WG_BN) + j
        c_end = c_split if first else n_cols
        for kt in range(nkt):
            k = kt * WG_BK + k_in
            ok = (k < K) & (c < c_end)
            ks.append(np.where(ok, k, -1))
            cs.append(np.where(ok, c, -1))
    return np.concatenate(ks), np.concatenate(cs)


# (K, n_cols, c_split): fig_5's Wi of layer 0 and 1-2 and its Wh (runs
# [0, 2H) and [2H, 3H)), the seq2seq encoder's Wi and Wh (3H = 1500 off
# the 128-column blocks), dx's Wi^T (one run), and odd small ones
IMAGES = [(840, 1536, 1024), (512, 1536, 1024), (100, 1500, 1000),
          (500, 1500, 1000), (1536, 512, 512), (1500, 100, 100),
          (7, 9, 6), (33, 3, 2)]


@pytest.mark.parametrize("K,n_cols,c_split", IMAGES)
def test_weight_image_holds_every_element_once(K, n_cols, c_split):
    ks, cs = image_index(K, n_cols, c_split)
    held = ks >= 0
    flat = ks[held] * n_cols + cs[held]
    assert np.array_equal(np.sort(flat), np.arange(K * n_cols))
    # a k8 step's slots t and t + 4 hold k = 8s + 2t and 8s + 2t + 1: the
    # columns that a thread's A fragment reads in one float2
    # (k chunk kc, q) of block column 0 in the first tile
    k_in = ks[np.arange(WG_BK // 4)[:, None] * (WG_BN // 8) * 32
              + np.arange(4)]
    if K >= WG_BK:
        for s in range(WG_BK // 8):
            for t in range(4):
                assert k_in[2 * s, t] == 8 * s + 2 * t
                assert k_in[2 * s + 1, t] == 8 * s + 2 * t + 1


def wgmma_product(segments, b_hi, b_lo):
    """out = [A_0 | A_1 | ...] B as wgmma_gemm_kernel orders it. Each
    segment (A, a_exact) is cut into 32-deep stages (its last zero padded);
    a stage's part starts from 0 and takes, for each k8 step, lo_a hi_b,
    hi_a lo_b, hi_a hi_b (no lo_a hi_b for an exact A), each an exact k8
    sum added into part rounding toward zero; part is added to the float32
    accumulator rounding to nearest. b_hi, b_lo: the planes of the image,
    (sum of the segments' K, N)."""
    acc = np.zeros((segments[0][0].shape[0], b_hi.shape[1]), np.float32)
    k0 = 0
    for a, exact in segments:
        K = a.shape[1]
        ah, al = (tf32(a), None) if exact else split(a)
        for kt in range(0, K, WG_BK):
            part = np.zeros_like(acc)
            for s in range(kt, min(kt + WG_BK, K), 8):
                ks = slice(s, min(s + 8, K))
                kb = slice(k0 + s, k0 + min(s + 8, K))
                terms = [(ah, b_lo), (ah, b_hi)]
                if al is not None:
                    terms.insert(0, (al, b_hi))
                for x, y in terms:
                    part = _rz(part.astype(np.float64) + x[:, ks].astype(
                        np.float64) @ y[kb].astype(np.float64))
            acc = acc + part
        k0 += K
    return acc


# (segments [(K, a's dtype)], N): x Wi over bf16 windows (K = 840), the
# gate recompute over [x | h] at fig_5's layer 0 (840 bf16 + 512), the
# seq2seq encoder's x Wi (K = 100) and dx = dgi Wi^T (K = 3H = 1536)
WG_CASES = {
    "x_wi_bf16_windows": ([(840, "bf16")], 64),
    "gate_recompute_two_segments": ([(840, "bf16"), (512, np.float32)], 64),
    "s2s_x_wi": ([(100, np.float32)], 64),
    "dx": ([(1536, np.float32)], 64),
}


@pytest.mark.parametrize("name", sorted(WG_CASES))
def test_wgmma_product_is_float32_class(name):
    segs, N = WG_CASES[name]
    rng = np.random.default_rng(40 + sorted(WG_CASES).index(name))
    segments = []
    for K, dt in segs:
        a = rng.uniform(-1, 1, size=(64, K)).astype(np.float32)
        segments.append((bf16(a) if dt == "bf16" else a, dt == "bf16"))
    K = sum(a.shape[1] for a, _ in segments)
    b = (rng.normal(size=(K, N)) * 1e-3).astype(np.float32)
    a_all = np.concatenate([a for a, _ in segments], axis=1)
    want = a_all.astype(np.float64) @ b.astype(np.float64)
    err = _rel(wgmma_product(segments, *split(b)), want)
    f32 = _rel(_tiled(a_all, b), want)
    print(f"{name}: wgmma 3xTF32 {err:.2e}, float32 {f32:.2e}")
    assert err <= GRAD_RTOL / 10
    assert err <= 4 * f32 + 1e-7


# ---------------------------------------------------------------------------
# the backward sweep's step (gru_bwd.cu: BwdStep and bwd_step_kernel),
# mirrored: one launch a step forms dh' = dgh Wh^T over K = 3H in two runs
# of k-tiles ([dr | dz] of g[t] against Wh[:, :2H]^T, dgn against
# Wh[:, 2H:]^T), split over a cluster of S CTAs where the step has few
# tiles; rank r sums rows [r BM/S, (r+1) BM/S) of the partial tiles in rank
# order and applies the next step's gate gradients to the whole sums
# ---------------------------------------------------------------------------

BWD_SPLITS = (1, 2, 4, 8, 16)
BWD_MAX_SPLIT = 16  # gru_bwd.cu: BwdStep::MAX_SPLIT


# The backward step's tile, GRU_MMA_SMALL of gru_mma.cuh, as (BM, BN, warps
# along M, warps along N, stages, CTAs per SM); the card test
# test_gru_bwd_step_split pins the rule as built
BWD_TILE = (64, 64, 2, 2, 3, 3)


def bwd_k_tiles(H: int):
    """The step's k-tiles in order: (segment, first k of the segment), the
    [dr | dz] run of 2H, then the dgn run of H, each cut at 32."""
    return ([(0, k) for k in range(0, 2 * H, TILE)]
            + [(1, k) for k in range(0, H, TILE)])


def bwd_split(B, H, tile=BWD_TILE, sms=H100_SMS, max_clusters=None):
    """step_split for BwdStep (at most 16) on a card of ``sms`` SMs whose
    clusters of S all fit at once unless ``max_clusters[S]`` says
    otherwise."""
    BM, BN, _, _, _, ctas = tile
    tiles = -(-B // BM) * -(-H // BN)
    n_k = len(bwd_k_tiles(H))
    for s in (16, 8, 4, 2):
        if (s <= BWD_MAX_SPLIT and s <= n_k and tiles * s <= ctas * sms
                and tiles <= (max_clusters or {}).get(s, tiles)):
            return s
    return 1


# (B, H, S) on the H100 at the default tile: b2t (B 64, H 768: 12 tiles),
# fig5 train (512 x 512: 64), seq2seq (1,224 x 500: 160), fig5 at the JAX
# default's B 2,000 (256), the stream (1 x 512: 8), conv_rnn (1,073 x 128:
# 34 tiles, 12 k-tiles), H 8 (two k-tiles)
BWD_SPLIT_CASES = [(64, 768, 16), (512, 512, 4), (1224, 500, 2),
                   (2000, 512, 1), (1, 512, 16), (1073, 128, 8), (64, 8, 2)]


@pytest.mark.parametrize("B,H,S", BWD_SPLIT_CASES)
def test_bwd_split_of_the_cells_shapes(B, H, S):
    assert bwd_split(B, H) == S


def test_bwd_split_steps_down_where_the_clusters_do_not_fit():
    assert bwd_split(64, 768, max_clusters={16: 11}) == 8
    assert bwd_split(64, 768, max_clusters={16: 0, 8: 0, 4: 0, 2: 0}) == 1
    # the wave: 64 tiles of 4 fill 256 of 396 slots; of 8, 512 would not
    assert bwd_split(512, 512, sms=66) == 2


@pytest.mark.parametrize("H,S", [(H, S) for H in (8, 50, 97, 200, 500, 512,
                                                  768)
                                 for S in BWD_SPLITS
                                 if S <= len(bwd_k_tiles(H))])
def test_bwd_step_runs_cover_the_gapped_k_once(H, S):
    """The ranks' runs of the k-tiles pair every column of g[t]'s [dr | dz]
    and dgn runs with its row of Wh^T once: g column c with Wh column c
    below 2H, g column 3H + c with Wh column 2H + c; g's dn run (columns
    [2H, 3H)) is never read."""
    tiles = bwd_k_tiles(H)
    runs = step_runs(len(tiles), S)
    assert runs[0][0] == 0 and runs[-1][1] == len(tiles)
    assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
    sizes = [b - a for a, b in runs]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    pairs = []
    for kt0, kt1 in runs:
        for seg, k0 in tiles[kt0:kt1]:
            K = 2 * H if seg == 0 else H
            for k in range(k0, min(k0 + TILE, K)):  # the rest zero filled
                pairs.append((k, k) if seg == 0 else (3 * H + k, 2 * H + k))
    want = [(c, c) for c in range(2 * H)] + [(3 * H + c, 2 * H + c)
                                             for c in range(H)]
    assert sorted(pairs) == sorted(want)


def bwd_owners(B, H, S, tile=BWD_TILE):
    """Every (b, j) that the grid's epilogues write, with the CTA (tile,
    rank) and thread that writes it: rank r of a tile's cluster takes rows
    [r BM/S, (r+1) BM/S) of the summed block, in runs of four units, run q
    to thread q % NT (S = 1: the CTA takes the whole block)."""
    BM, BN, warps_m, warps_n, _, _ = tile
    NT, RB, G4 = 32 * warps_m * warps_n, BM // S, BN // 4
    n_tn = -(-H // BN)
    out = []
    for tile_i in range(-(-B // BM) * n_tn):
        m0, n0 = (tile_i // n_tn) * BM, (tile_i % n_tn) * BN
        for rank in range(S):
            for q in range(RB * G4):
                m = m0 + rank * RB + q // G4
                for u in range(4):
                    j = n0 + (q % G4) * 4 + u
                    if m < B and j < H:
                        out.append((m, j, tile_i, rank, q % NT))
    return out


@pytest.mark.parametrize("B,H,S", [(64, 768, 16), (64, 768, 1), (130, 97, 2),
                                   (512, 512, 4), (1, 50, 8), (70, 64, 16)])
def test_bwd_epilogue_owns_each_unit_once(B, H, S):
    """Each (b, j) of dh' is written by one thread of one CTA of the grid:
    the one that applies step t''s gate gradients there, so that the
    in-place g[t'] and d z need no barrier inside the launch."""
    owners = bwd_owners(B, H, S)
    cells = sorted((m, j) for m, j, *_ in owners)
    assert cells == [(m, j) for m in range(B) for j in range(H)]


@pytest.mark.parametrize("S", [s for s in BWD_SPLITS
                               if BWD_TILE[0] % s == 0])
def test_bwd_partial_tile_holds_each_product_once(S):
    """The float2 stores of every thread's acc[mi][ni][2h + e] fill the
    partial tile [row][column] once, free of bank conflicts (pitch BN + 8,
    8 mod 32), and the ranks' rows cover the tile once, in runs of four
    units that start 16 bytes apart (float4 reads)."""
    BM, BN, warps_m, warps_n, _, _ = BWD_TILE
    WM, WN, RP = BM // warps_m, BN // warps_n, BN + 8
    assert RP % 32 == 8 and (RP * 4) % 16 == 0 and BN % 4 == 0
    seen = []
    for warp in range(warps_m * warps_n):
        wm, wn = (warp // warps_n) * WM, (warp % warps_n) * WN
        for mi in range(WM // 16):
            for ni in range(WN // 8):
                for h in range(2):
                    banks = []
                    for lane in range(32):
                        g, t = lane >> 2, lane & 3
                        row, col = wm + mi * 16 + g + h * 8, wn + ni * 8 + 2 * t
                        banks.append((row * RP + col) % 32)
                        seen += [(row, col), (row, col + 1)]
                    for half in (banks[:16], banks[16:]):
                        words = sorted(b + e for b in half for e in range(2))
                        assert words == list(range(32))
    assert sorted(seen) == [(r, c) for r in range(BM) for c in range(BN)]
    rows = [rank * (BM // S) + i for rank in range(S) for i in range(BM // S)]
    assert rows == list(range(BM))


def _gate_grads(pre, hprev, d, H):
    """The gate gradients of a step from d = the carried gradient + dhs:
    dgh = [dr | dz | dgn] and d z, in the working type of the inputs."""
    r = 1 / (1 + np.exp(-pre[:, :H]))
    z = 1 / (1 + np.exp(-pre[:, H:2 * H]))
    ghn = pre[:, 3 * H:]
    n = np.tanh(pre[:, 2 * H:3 * H] + r * ghn)
    dz = d * (hprev - n) * z * (1 - z)
    dn = d * (1 - z) * (1 - n * n)
    dr = dn * ghn * r * (1 - r)
    return np.concatenate([dr, dz, dn * r], axis=1), d * z


def bwd_sweep(pre, hprev, dhs, wh, S=None):
    """The backward sweep over T steps (the forward ran forward, so from
    t = T - 1 down): dh0 and dWh = sum_t hprev[t]^T dgh[t]. S = None: in
    float64. Else as the kernels take it in float32: each step's dgh Wh^T
    over the k-tiles of bwd_k_tiles, each tile's three TF32 products summed
    into a part from 0 and added into the rank's float32 partial, the
    partials added in rank order; the carried gradient d z + that sum."""
    T, B, G4 = pre.shape
    H = G4 // 4
    f64 = S is None
    dt = np.float64 if f64 else np.float32
    if not f64:
        tiles = bwd_k_tiles(H)
        runs = step_runs(len(tiles), S)
        wt = wh.T  # (3H, H): rows [0, 2H) for [dr | dz], [2H, 3H) for dgn
        bh, bl = split(wt)
        rows = np.array([(0 if seg == 0 else 2 * H) + k0
                         for seg, k0 in tiles])
        cols = np.array([(0 if seg == 0 else 2 * H) + k0
                         for seg, k0 in tiles])
        b_hi = np.stack([bh[r:r + TILE] for r in rows])
        b_lo = np.stack([bl[r:r + TILE] for r in rows])
    dwh = np.zeros((H, 3 * H))
    dhz = None
    for s in range(T):
        t = T - 1 - s
        c = np.zeros((B, H), dt) if s == 0 else (dhz + prod).astype(dt)
        dgh, dhz = _gate_grads(pre[t].astype(dt), hprev[t].astype(dt),
                               (c + dhs[t].astype(dt)).astype(dt), H)
        dhz = dhz.astype(dt)
        dwh += hprev[t].astype(np.float64).T @ dgh.astype(np.float64)
        if f64:
            prod = dgh @ wh.T
            continue
        ah, al = split(dgh.astype(np.float32))
        a_hi = np.stack([ah[:, c_:c_ + TILE] for c_ in cols])
        a_lo = np.stack([al[:, c_:c_ + TILE] for c_ in cols])
        part = (np.matmul(a_lo, b_hi) + np.matmul(a_hi, b_lo)
                + np.matmul(a_hi, b_hi))  # (tiles, B, H) float32
        prod = None
        for kt0, kt1 in runs:
            acc = np.zeros((B, H), np.float32)
            for kt in range(kt0, kt1):
                acc += part[kt]
            prod = acc if prod is None else prod + acc
    dh0 = (dhz + prod).astype(dt)
    return dh0, dwh


@pytest.mark.parametrize("S", [1, 16])
def test_split_backward_sweep_stays_within_grad_rtol(S):
    """120 steps of the backward sweep at the b2t width (B = 64, H = 768,
    72 k-tiles) with each step's dh' split over S ranks: dh0 and dWh within
    GRAD_RTOL of float64, 10x inside, as the unsplit sum."""
    T, B, H = 120, 64, 768
    rng = np.random.default_rng(7)
    pre = rng.normal(size=(T, B, 4 * H)).astype(np.float32)
    hprev = rng.uniform(-1, 1, (T, B, H)).astype(np.float32)
    dhs = (rng.normal(size=(T, B, H)) * 1e-3).astype(np.float32)
    wh = (rng.normal(size=(H, 3 * H)) / np.sqrt(H)).astype(np.float32)
    want = bwd_sweep(pre, hprev, dhs, wh)
    got = bwd_sweep(pre, hprev, dhs, wh, S)
    errs = [_rel(g, w) for g, w in zip(got, want)]
    print(f"B=64 H=768 S={S}: dh0 {errs[0]:.2e}, dWh {errs[1]:.2e}")
    assert max(errs) <= GRAD_RTOL / 10
