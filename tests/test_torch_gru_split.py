"""The operand split of the backward kernels' tensor-core products, emulated
in numpy on the CPU.

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
one-pass TF32 and bf16 products, which it replaces, are shown not to.
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


def split_product(a, b, n_parts: int = 1, a_exact: bool = False):
    """The kernel's 3xTF32 product (2 products when a is exact in TF32)."""
    ah, al = (tf32(a), None) if a_exact else split(a)
    bh, bl = split(b)
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
