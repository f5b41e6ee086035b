"""The port's CUDA kernels against their plain versions on the card.

Every test here needs a CUDA card and skips without one. The file imports
neither JAX nor the JAX package, so it runs on a machine that has only
PyTorch:

    python -m pytest tests/test_torch_kernels.py --noconftest -m gpu

(``--noconftest`` skips ``tests/conftest.py``, which configures JAX.)
GRU forward: every forward kernel's products run on tensor cores as
3xTF32 (float32-class), the bidirectional kernel as the unidirectional
one's two phases per direction; each against the plain version in float32
sums of another order: atol 1e-4 on hs. The step kernels' split of K over
a cluster (forward and backward) changes only that order, and two runs
give the same bits. The
products whose B is a weight (the projections, the backward's gate
recompute, dx) run on wgmma where a call's T B rows reach the library's
threshold and on mma.sync below it; the tile-edge shapes cross it. GRU backward: the kernels' products run
on tensor cores as 3xTF32 (float32-class, ~1e-7 of the largest output per
product) with float32 sums in another order: on gradients, max |diff| <=
1e-5 x max |plain| per tensor (sums over batch and time). Jacobi: the kernel rounds every
rotation as the plain version's tensor ops do, so w, V and the sweep
counts are bit for bit those of the plain version; the
alignment fit on the card agrees with the CPU's within 1e-4 on the
canonical correlations and 1e-3 x max |proj| on the projections.
"""

import ctypes

import numpy as np
import pytest
import torch

from cross_patient_speech_decoding_tpu_torch.models import RealtimeRNN
from cross_patient_speech_decoding_tpu_torch.ops import _ext, cca, gru, jacobi

ATOL = 1e-4
GRAD_RTOL = 1e-5

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _wgmma_rows(n_rows: int) -> bool:
    """Whether the library takes the weight products of a call of n_rows
    = T B rows on wgmma (GRU_WGMMA_MIN_ROWS, csrc/gru_mma.cuh)."""
    n = ctypes.c_longlong()
    _ext.check(_ext.lib().gru_fwd_wimg(n_rows, 1, 1, ctypes.byref(n)),
               "gru_fwd_wimg")
    return n.value > 0


def _args(card, seed, T, B, F, H):
    rng = np.random.default_rng(seed)
    arrs = [
        rng.normal(size=(T, B, F)) * 0.5,
        rng.normal(size=(B, H)) * 0.3,
        rng.normal(size=(F, 3 * H)) / np.sqrt(F),
        rng.normal(size=(3 * H,)) * 0.1,
        rng.normal(size=(H, 3 * H)) / np.sqrt(H),
        rng.normal(size=(3 * H,)) * 0.1,
    ]
    return [torch.as_tensor(a, dtype=torch.float32, device=card)
            for a in arrs]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("T,B,F,H", [(6, 16, 10, 32), (5, 10, 9, 50),
                                     (3, 130, 70, 97)])
def test_gru_fwd_kernel_matches_plain(card, dtype, reverse, T, B, F, H):
    args = _args(card, 1, T, B, F, H)
    args[0] = args[0].to(dtype)
    gru.reset_launch_counts()
    with torch.no_grad():
        got = gru.gru_layer(*args, reverse=reverse)
        want = gru.gru_layer_plain(*args, reverse=reverse)
    assert gru.LAUNCHES["gru_fwd"] == 1
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("batch_major", [True, False])
@pytest.mark.parametrize("win,stride,T", [(6, 2, 26), (6, 2, 27), (4, 4, 16),
                                          (7, 3, 23)])
def test_gru_wfwd_kernel_matches_plain(card, win, stride, T, batch_major):
    B, C, H = 10, 5, 50
    args = _args(card, 2, T, B, win * C, H)
    # bf16 raw frames as a (T, B, C) view of a batch-major (B, T, C)
    # tensor, which the kernel reads as it is, or as time-major (T, B, C)
    # frames, which the wrapper copies to batch-major first
    x = torch.randn((B, T, C), device=card).to(torch.bfloat16)
    args[0] = x.transpose(0, 1)
    if not batch_major:
        args[0] = args[0].contiguous()
    assert (args[0].stride(0) == C) == batch_major
    gru.reset_launch_counts()
    with torch.no_grad():
        got = gru.gru_layer_windowed(*args, win, stride)
        want = gru.gru_layer_windowed_plain(*args, win, stride)
    assert gru.LAUNCHES["gru_wfwd"] == 1
    assert got.shape == ((T - win) // stride + 1, B, H)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


# shapes that cross the forward's tiles: B off the step kernel's 64-row
# tile and the projection's 128-row tile, H = 500 (off the 32-unit tile),
# H = 1, T = 1, odd F; T B past the wgmma route's threshold (ragged 128-row
# tiles, K = 100 and 840, 3H = 1500 off the 128-column tile)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("T,B,F,H", [(3, 131, 100, 500), (1, 1000, 500, 500),
                                     (4, 65, 33, 1), (1, 1, 840, 512),
                                     (2, 129, 70, 97), (5, 1001, 100, 500),
                                     (3, 1500, 840, 512)])
def test_gru_fwd_kernel_tile_edges(card, dtype, reverse, T, B, F, H):
    args = _args(card, 14, T, B, F, H)
    args[0] = args[0].to(dtype)
    with torch.no_grad():
        got = gru.gru_fwd_cuda(*args, reverse=reverse)
        again = gru.gru_fwd_cuda(*args, reverse=reverse)
        want = gru.gru_layer_plain(*args, reverse=reverse)
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


# window rows of F = win*C = 840 (C = 60, 16-byte aligned, as at fig_5
# width) and of C = 5 (2-byte aligned), B off the tiles, H = 500, 97, 1;
# 35 x 131 windows take the wgmma route
@pytest.mark.parametrize("batch_major", [True, False])
@pytest.mark.parametrize("win,stride,T,C,B,H", [(14, 4, 30, 60, 67, 500),
                                                (14, 4, 40, 60, 130, 97),
                                                (6, 2, 27, 5, 129, 64),
                                                (6, 2, 11, 5, 3, 1),
                                                (14, 4, 150, 60, 131, 500)])
def test_gru_wfwd_kernel_tile_edges(card, win, stride, T, C, B, H,
                                    batch_major):
    args = _args(card, 15, T, B, win * C, H)
    x = torch.randn((B, T, C), device=card).to(torch.bfloat16).transpose(0, 1)
    args[0] = x if batch_major else x.contiguous()
    with torch.no_grad():
        got = gru.gru_wfwd_cuda(*args, win, stride)
        assert torch.equal(got, gru.gru_wfwd_cuda(*args, win, stride))
        want = gru.gru_layer_windowed_plain(*args, win, stride)
    assert got.shape == ((T - win) // stride + 1, B, H)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


# the step kernel's split of K over a cluster of S CTAs (gru_mma.cuh:
# step_split), at shapes that land on each S on the H100 (132 SMs, 2 step
# CTAs on each): (T, B, F, H, S). B = 1224, 320 tiles: no split; B = 512
# and 10 (H = 512, 50): 2; H = 200 (7 k-tiles, uneven runs of 1-2 over 4
# ranks) and B = 130, H = 97 (K 97: its last k-tile ragged): 4; the b2t
# shape B = 64, H = 768 (24 tiles) and B = 1, H = 500 (K off 8 x 32, H off
# the 32-unit tile): 8
STEP_SPLIT_CASES = [(2, 1224, 100, 500, 1), (3, 512, 64, 512, 2),
                    (5, 10, 9, 50, 2), (4, 64, 30, 200, 4),
                    (3, 130, 70, 97, 4), (4, 64, 768, 768, 8),
                    (6, 1, 30, 500, 8)]


def _steps(split: int, n: int) -> dict:
    return {s: n if s == split else 0 for s in gru.STEP_SPLITS}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,B,F,H,split", STEP_SPLIT_CASES)
def test_gru_fwd_step_split(card, dtype, T, B, F, H, split):
    """Each shape's steps launch in clusters of its S (step_counts), hold
    to the plain version at ATOL, and two runs give the same bits."""
    args = _args(card, 16, T, B, F, H)
    args[0] = args[0].to(dtype)
    with torch.no_grad():
        gru.reset_launch_counts()
        got = gru.gru_fwd_cuda(*args)
        assert gru.step_counts() == _steps(split, T)
        again = gru.gru_fwd_cuda(*args)
        want = gru.gru_layer_plain(*args)
    assert gru.step_counts() == _steps(split, 2 * T)
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


def test_gru_wfwd_step_split_at_the_b2t_shape(card):
    """The b2t cell's layer 0: 14 x 4 windows over 512 features, B = 64,
    H = 768, every step in clusters of 8."""
    T, B, C, H, win, stride = 30, 64, 512, 768, 14, 4
    args = _args(card, 17, 1, B, win * C, H)
    x = torch.randn((B, T, C), device=card).to(torch.bfloat16).transpose(0, 1)
    with torch.no_grad():
        gru.reset_launch_counts()
        got = gru.gru_wfwd_cuda(x, *args[1:], win, stride)
        again = gru.gru_wfwd_cuda(x, *args[1:], win, stride)
        want = gru.gru_layer_windowed_plain(x, *args[1:], win, stride)
    n_win = (T - win) // stride + 1
    assert gru.step_counts() == _steps(8, 2 * n_win)
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


def test_wrappers_raise_on_cuda_instead_of_falling_back(card):
    args = _args(card, 3, 4, 8, 6, 16)
    with torch.no_grad():
        with pytest.raises(TypeError, match="x must be"):
            gru.gru_layer(args[0].double(), *args[1:])
        with pytest.raises(ValueError, match="is on"):
            gru.gru_layer(args[0], args[1].cpu(), *args[2:])
        # the windowed kernel reads bf16 frames only
        frames = torch.randn((5, 8, 3), device=card)
        with pytest.raises(TypeError, match="bfloat16 frames"):
            gru.gru_layer_windowed(frames, *args[1:], 2, 1)


def _assert_grads_close(got, want):
    assert (got[0] is None) == (want[0] is None)
    for g, w in zip(got, want):
        if w is not None:
            tol = GRAD_RTOL * float(w.abs().max())
            torch.testing.assert_close(g, w, atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("need_dx", [True, False])
@pytest.mark.parametrize("T,B,F,H", [(6, 16, 10, 32), (5, 10, 9, 50),
                                     (3, 130, 70, 97)])
def test_gru_bwd_kernel_matches_plain(card, dtype, reverse, need_dx, T, B,
                                      F, H):
    x, _, *w = _args(card, 4, T, B, F, H)
    x = x.to(dtype)
    hprev = torch.randn((T, B, H), device=card) * 0.3
    dhs = torch.randn((T, B, H), device=card)
    gru.reset_launch_counts()
    got = gru.gru_bwd_cuda(x, hprev, dhs, *w, reverse, need_dx)
    want = gru.gru_backward_plain(x, hprev, dhs, *w, reverse, need_dx)
    assert gru.LAUNCHES["gru_bwd"] == 1
    _assert_grads_close(got, want)
    # fixed partials summed in a fixed order: the same gradients again
    again = gru.gru_bwd_cuda(x, hprev, dhs, *w, reverse, need_dx)
    assert all(a is None or torch.equal(a, b) for a, b in zip(again, got))


@pytest.mark.parametrize("batch_major", [True, False])
@pytest.mark.parametrize("win,stride,T", [(6, 2, 26), (6, 2, 27), (4, 4, 16),
                                          (7, 3, 23)])
def test_gru_wbwd_kernel_matches_plain(card, win, stride, T, batch_major):
    B, C, H = 10, 5, 50
    n_win = (T - win) // stride + 1
    _, _, *w = _args(card, 5, T, B, win * C, H)
    x = torch.randn((B, T, C), device=card).to(torch.bfloat16).transpose(0, 1)
    if not batch_major:
        x = x.contiguous()
    hprev = torch.randn((n_win, B, H), device=card) * 0.3
    dhs = torch.randn((n_win, B, H), device=card)
    gru.reset_launch_counts()
    got = gru.gru_wbwd_cuda(x, hprev, dhs, *w, win, stride)
    want = gru.gru_win_backward_plain(x, hprev, dhs, *w, win, stride)
    assert gru.LAUNCHES["gru_wbwd"] == 1 and got[0] is None
    _assert_grads_close(got, want)
    again = gru.gru_wbwd_cuda(x, hprev, dhs, *w, win, stride)
    assert all(a is None or torch.equal(a, b) for a, b in zip(again, got))


# shapes that cross the tensor-core tiles' edges: H = 500 (3H = 1500),
# F = 840, T = 1, B off the 128- and 64-row tiles, odd H and F; T B past
# the wgmma route's threshold with K = 100, and K = 840 + 512 = 1352 over
# the recompute's two segments
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("need_dx", [True, False])
@pytest.mark.parametrize("T,B,F,H", [(3, 131, 100, 500), (1, 1000, 500, 500),
                                     (2, 70, 840, 64), (1, 129, 33, 97),
                                     (5, 1001, 100, 500),
                                     (4, 1100, 840, 512)])
def test_gru_bwd_kernel_tile_edges(card, dtype, reverse, need_dx, T, B, F,
                                   H):
    x, _, *w = _args(card, 12, T, B, F, H)
    x = x.to(dtype)
    hprev = torch.randn((T, B, H), device=card) * 0.3
    dhs = torch.randn((T, B, H), device=card)
    got = gru.gru_bwd_cuda(x, hprev, dhs, *w, reverse, need_dx)
    want = gru.gru_backward_plain(x, hprev, dhs, *w, reverse, need_dx)
    _assert_grads_close(got, want)
    again = gru.gru_bwd_cuda(x, hprev, dhs, *w, reverse, need_dx)
    assert all(a is None or torch.equal(a, b) for a, b in zip(again, got))


# window rows of F = win*C = 840 (C = 60, 16-byte aligned, as at fig_5
# width) and of C = 5 (2-byte aligned), B off the tiles, H = 500 and 97;
# 35 x 131 windows take the wgmma route
@pytest.mark.parametrize("batch_major", [True, False])
@pytest.mark.parametrize("win,stride,T,C,B,H", [(14, 4, 30, 60, 67, 500),
                                                (14, 4, 40, 60, 130, 97),
                                                (6, 2, 27, 5, 129, 64),
                                                (14, 4, 150, 60, 131, 500)])
def test_gru_wbwd_kernel_tile_edges(card, win, stride, T, C, B, H,
                                    batch_major):
    n_win = (T - win) // stride + 1
    _, _, *w = _args(card, 13, T, B, win * C, H)
    x = torch.randn((B, T, C), device=card).to(torch.bfloat16).transpose(0, 1)
    if not batch_major:
        x = x.contiguous()
    hprev = torch.randn((n_win, B, H), device=card) * 0.3
    dhs = torch.randn((n_win, B, H), device=card)
    got = gru.gru_wbwd_cuda(x, hprev, dhs, *w, win, stride)
    want = gru.gru_win_backward_plain(x, hprev, dhs, *w, win, stride)
    _assert_grads_close(got, want)
    again = gru.gru_wbwd_cuda(x, hprev, dhs, *w, win, stride)
    assert all(a is None or torch.equal(a, b) for a, b in zip(again, got))


# the backward sweep's step split over a cluster of S CTAs (gru_mma.cuh:
# step_split), at the cells' shapes on the H100 (132 SMs, 3 step CTAs on
# each, 64 x 64 tiles): (T, B, F, H, S). b2t's B = 64, H = 768 (12 tiles):
# 16; fig5 train's B = 512, H = 512 (64 tiles): 4; the seq2seq encoder's and
# decoder's B = 1224, H = 500 (160 tiles): 2; fig5 at B = 2000 (256 tiles):
# none. T = 1: the first step's launch, then one that writes dh0.
BWD_SPLIT_CASES = [(2, 64, 768, 768, 16), (1, 64, 768, 768, 16),
                   (2, 512, 512, 512, 4), (1, 512, 512, 512, 4),
                   (2, 1224, 100, 500, 2), (1, 1224, 500, 500, 2),
                   (2, 2000, 512, 512, 1), (1, 2000, 512, 512, 1)]


def _bwd_steps(split: int, n: int) -> dict:
    return {s: n if s == split else 0 for s in gru.BWD_STEP_SPLITS}


@pytest.mark.parametrize("need_dx", [True, False])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("T,B,F,H,split", BWD_SPLIT_CASES)
def test_gru_bwd_step_split(card, reverse, need_dx, T, B, F, H, split):
    """Each shape's sweep launches once a step, in clusters of its S
    (bwd_step_counts), holds to the plain backward at GRAD_RTOL, and two
    runs give the same bits."""
    x, _, *w = _args(card, 30, T, B, F, H)
    hprev = torch.randn((T, B, H), device=card) * 0.3
    dhs = torch.randn((T, B, H), device=card)
    gru.reset_launch_counts()
    got = gru.gru_bwd_cuda(x, hprev, dhs, *w, reverse, need_dx)
    assert gru.bwd_step_counts() == _bwd_steps(split, T)
    again = gru.gru_bwd_cuda(x, hprev, dhs, *w, reverse, need_dx)
    assert gru.bwd_step_counts() == _bwd_steps(split, 2 * T)
    want = gru.gru_backward_plain(x, hprev, dhs, *w, reverse, need_dx)
    _assert_grads_close(got, want)
    assert all(a is None or torch.equal(a, b) for a, b in zip(again, got))


@pytest.mark.parametrize("need_dx", [True, False])
@pytest.mark.parametrize("n_win", [1, 2, 5])
def test_gru_wbwd_step_split_at_the_b2t_shape(card, need_dx, n_win):
    """The b2t cell's layer 0: 14 x 4 windows over 512 features, B = 64,
    H = 768, with and without the frames' gradient: every sweep step in
    clusters of 16, against the plain version, two runs bitwise equal."""
    B, C, H, win, stride = 64, 512, 768, 14, 4
    T = win + (n_win - 1) * stride
    _, _, *w = _args(card, 31, 1, B, win * C, H)
    x = torch.randn((B, T, C), device=card).to(torch.bfloat16).transpose(0, 1)
    hprev = torch.randn((n_win, B, H), device=card) * 0.3
    dhs = torch.randn((n_win, B, H), device=card)
    gru.reset_launch_counts()
    got = gru.gru_wbwd_cuda(x, hprev, dhs, *w, win, stride, need_dx)
    again = gru.gru_wbwd_cuda(x, hprev, dhs, *w, win, stride, need_dx)
    assert gru.bwd_step_counts() == _bwd_steps(16, 2 * n_win)
    want = gru.gru_win_backward_plain(x, hprev, dhs, *w, win, stride,
                                      need_dx=need_dx)
    _assert_grads_close(got, want)
    assert all(a is None or torch.equal(a, b) for a, b in zip(again, got))


def test_backward_wrappers_raise_on_cuda(card):
    x, _, *w = _args(card, 6, 4, 8, 6, 16)
    hprev = torch.zeros((4, 8, 16), device=card)
    with pytest.raises(ValueError, match="dhs has shape"):
        gru.gru_bwd_cuda(x, hprev, hprev[:3], *w)
    with pytest.raises(TypeError, match="bfloat16 frames"):
        gru.gru_wbwd_cuda(torch.randn((5, 8, 3), device=card), hprev[:2],
                          hprev[:2], torch.zeros((6, 48), device=card),
                          *w[1:], 2, 2)


# calls past the wgmma route's threshold, with their weight products:
# gru_fwd (x Wi), gru_wfwd (windows read in place), gru_bifwd (x Wi of
# each direction), gru_bwd (the three gate-recompute products, dx) and
# gru_wbwd (the recompute alone)
def _route_calls(card):
    x, h0, *w = _args(card, 20, 5, 1001, 100, 500)
    hp = torch.randn((5, 1001, 500), device=card) * 0.3
    dh = torch.randn((5, 1001, 500), device=card)
    frames = torch.randn((131, 150, 60), device=card).to(
        torch.bfloat16).transpose(0, 1)
    _, h0w, *ww = _args(card, 21, 1, 131, 840, 500)
    hpw = torch.randn((35, 131, 500), device=card) * 0.3
    dhw = torch.randn((35, 131, 500), device=card)
    return {
        "gru_fwd": (1, lambda: gru.gru_fwd_cuda(x, h0, *w)),
        "gru_wfwd": (1, lambda: gru.gru_wfwd_cuda(frames, h0w, *ww, 14, 4)),
        "gru_bifwd": (2, lambda: gru.gru_bifwd_cuda(x, h0, h0, *w, *w)),
        "gru_bwd": (4, lambda: gru.gru_bwd_cuda(x, hp, dh, *w)),
        "gru_bwd_no_dx": (3, lambda: gru.gru_bwd_cuda(x, hp, dh, *w,
                                                      need_dx=False)),
        "gru_wbwd": (3, lambda: gru.gru_wbwd_cuda(frames, hpw, dhw, *ww, 14,
                                                  4)),
    }


@pytest.mark.parametrize("call", ["gru_fwd", "gru_wfwd", "gru_bifwd",
                                  "gru_bwd", "gru_bwd_no_dx", "gru_wbwd"])
def test_weight_products_take_wgmma_past_the_threshold(card, call):
    """Each call's weight products, counted by route: all on wgmma at
    5 x 1001 and 35 x 131 rows, and reset with the launch counts."""
    assert _wgmma_rows(5 * 1001) and _wgmma_rows(35 * 131)
    n, fn = _route_calls(card)[call]
    gru.reset_launch_counts()
    with torch.no_grad():
        fn()
    assert gru.product_counts() == {"wgmma": n, "mma_sync": 0}
    gru.reset_launch_counts()
    assert gru.product_counts() == {"wgmma": 0, "mma_sync": 0}


def test_fig5_step_takes_wgmma_and_a_stream_step_mma_sync(card):
    """A train step of the fig_5 model (64 rows of 600 frames: 147 x 64
    rows a layer) sends all 14 of its weight products through wgmma (3
    projections, 9 gate recomputes, dx of layers 1-2); a streaming step
    (B = 1, T = 1) sends its 3 projections through mma.sync."""
    model = RealtimeRNN(60, 512, 3, 11, dropout=0.0, win_size=14, stride=4,
                        seed=0, device=card)
    x = torch.randn((64, 600, 60), device=card)
    assert _wgmma_rows(147 * 64) and not _wgmma_rows(1)
    gru.reset_launch_counts()
    model(x).square().mean().backward()
    assert gru.product_counts() == {"wgmma": 14, "mma_sync": 0}
    gru.reset_launch_counts()
    with torch.no_grad():
        model.single_step(x[:1, :14].reshape(1, -1),
                          model.initial_hidden(1).contiguous())
    assert gru.product_counts() == {"wgmma": 0, "mma_sync": 3}


def test_realtime_rnn_on_card_matches_cpu(card):
    model = RealtimeRNN(5, 32, 3, 7, win_size=6, stride=2, seed=0,
                        device="cpu").eval()
    x = torch.randn((12, 40, 5), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = model(x)
        model.to(card)
        gru.reset_launch_counts()
        got = model(x.to(card)).cpu()
    assert gru.LAUNCHES == {"gru_fwd": 2, "gru_wfwd": 1, "gru_bifwd": 0,
                            "gru_bwd": 0, "gru_wbwd": 0}
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


def test_realtime_rnn_gradients_on_card_match_cpu(card):
    """The loss's gradient through the four kernels against the same model
    on the CPU (plain versions), one train-mode backward at dropout 0."""
    from cross_patient_speech_decoding_tpu_torch.ops.ctc import ctc_loss_mean

    model = RealtimeRNN(5, 32, 3, 7, dropout=0.0, win_size=6, stride=2,
                        seed=0, device="cpu")
    g = torch.Generator().manual_seed(0)
    x = torch.randn((12, 40, 5), generator=g)
    labels = torch.randint(1, 7, (12, 4), generator=g)
    il = torch.full((12,), 18)
    ll = torch.full((12,), 4)

    def grads():
        dev = model.h0.device
        loss = ctc_loss_mean(model(x.to(dev)), il.to(dev), labels.to(dev),
                             ll.to(dev))
        return [p.cpu() for p in torch.autograd.grad(
            loss, list(model.parameters()))]

    want = grads()
    model.to(card)
    gru.reset_launch_counts()
    got = grads()
    assert gru.LAUNCHES == {"gru_fwd": 2, "gru_wfwd": 1, "gru_bifwd": 0,
                            "gru_bwd": 2, "gru_wbwd": 1}
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4 * float(b.abs().max()),
                                   rtol=0)


def _bidir_args(card, seed, T, B, F, H, dtype):
    x, h0_f, *w_f = _args(card, seed, T, B, F, H)
    _, h0_b, *w_b = _args(card, seed + 1, T, B, F, H)
    return [x.to(dtype), h0_f, h0_b, *w_f, *w_b]


# (T, B, F, H): T at 1, 2 and 191, odd B and H, the seq2seq encoder's
# B = 1000, H = 500, and wide H
BIFWD_CASES = [
    (1, 1, 3, 1), (1, 7, 5, 33), (2, 7, 5, 33), (6, 16, 10, 32),
    (3, 130, 70, 97), (191, 33, 20, 7), (2, 1000, 100, 500),
    (191, 1000, 100, 500), (2, 40, 9, 544), (2, 40, 9, 800),
    (3, 65, 33, 1024), (2, 7, 5, 833),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,B,F,H", BIFWD_CASES)
def test_gru_bifwd_kernel_matches_plain(card, dtype, T, B, F, H):
    """The forward direction's projection and sweep, then the reversed
    one's: one launch count a call, two runs bitwise equal, bitwise equal
    to two gru_fwd launches, and against the plain version (two plain
    sweeps) to ATOL."""
    args = _bidir_args(card, 7, T, B, F, H, dtype)
    x, h0_f, h0_b, *w = args
    gru.reset_launch_counts()
    with torch.no_grad():
        got = gru.gru_layer_bidir(*args)
        assert gru.LAUNCHES == {"gru_fwd": 0, "gru_wfwd": 0, "gru_bifwd": 1,
                                "gru_bwd": 0, "gru_wbwd": 0}
        again = gru.gru_bifwd_cuda(*args)
        want = gru.gru_layer_bidir_plain(*args)
        unfused = (gru.gru_fwd_cuda(x, h0_f, *w[:4]),
                   gru.gru_fwd_cuda(x, h0_b, *w[4:], reverse=True))
    for g, a, w_, u in zip(got, again, want, unfused):
        assert torch.equal(g, a)
        assert torch.equal(g, u)
        torch.testing.assert_close(g, w_, atol=ATOL, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gru_bifwd_at_a_split_shape_equals_two_gru_fwd(card, dtype):
    """At B = 64, H = 768 both directions' steps split over 8 CTAs, and
    gru_bifwd stays bit for bit two gru_fwd launches."""
    T = 3
    x, h0_f, h0_b, *w = _bidir_args(card, 18, T, 64, 100, 768, dtype)
    with torch.no_grad():
        gru.reset_launch_counts()
        got = gru.gru_bifwd_cuda(x, h0_f, h0_b, *w)
        assert gru.step_counts() == _steps(8, 2 * T)
        unfused = (gru.gru_fwd_cuda(x, h0_f, *w[:4]),
                   gru.gru_fwd_cuda(x, h0_b, *w[4:], reverse=True))
    for g, u in zip(got, unfused):
        assert torch.equal(g, u)


@pytest.mark.parametrize("need_dx", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gru_bidir_grads_match_plain(card, need_dx, dtype):
    """GRUBidirFn through the kernels (gru_bifwd, then gru_bwd forward and
    reversed) against the same Function through the plain versions, on
    the card: every gradient to GRAD_RTOL x its largest value."""
    args = _bidir_args(card, 8, 5, 10, 9, 50, dtype)
    rng = np.random.default_rng(9)
    dhs = [torch.as_tensor(rng.normal(size=(5, 10, 50)), dtype=torch.float32,
                           device=card) for _ in range(2)]

    def grads(plain):
        ts = [a.detach().clone().requires_grad_(i > 0 or need_dx)
              for i, a in enumerate(args)]
        out = gru.GRUBidirFn.apply(*ts, plain)
        torch.autograd.backward(out, dhs)
        return [t.grad for t in ts]

    gru.reset_launch_counts()
    got = grads(False)
    assert gru.LAUNCHES["gru_bifwd"] == 1 and gru.LAUNCHES["gru_bwd"] == 2
    want = grads(True)
    assert (got[0] is None) == (not need_dx)
    if need_dx and dtype == torch.bfloat16:
        # dx comes back in x's dtype: one bf16 rounding of a float32 sum
        assert got[0].dtype == torch.bfloat16
        torch.testing.assert_close(got[0].float(), want[0].float(),
                                   atol=1e-2 * float(want[0].abs().max()),
                                   rtol=0)
        got[0] = want[0] = None
    _assert_grads_close(got, want)


def test_bifwd_wrapper_raises_on_cuda(card):
    args = _bidir_args(card, 10, 4, 8, 6, 16, torch.float32)
    other = _args(card, 11, 4, 8, 6, 17)  # a reverse direction of H=17
    with pytest.raises(ValueError, match="hidden sizes differ"):
        gru.gru_bifwd_cuda(args[0], args[1], other[1], *args[3:7],
                           *other[2:])
    with pytest.raises(ValueError, match="contiguous last axis"):
        gru.gru_bifwd_cuda(args[0].transpose(0, 2).contiguous()
                           .transpose(0, 2), *args[1:])
    with pytest.raises(ValueError, match="is on"):
        gru.gru_bifwd_cuda(args[0], args[1], args[2].cpu(), *args[3:])


def test_seq2seq_on_card_matches_cpu(card):
    """A small Seq2SeqRNN on the card against the same model on the CPU:
    eval logits to ATOL, and the train-mode loss's gradients (teacher
    forcing 1, dropout 0) to 1e-4 x their largest value (the conv bias's,
    0 in exact arithmetic behind the BatchNorm, to 1e-4 x the conv
    weight's), with one gru_bifwd and three gru_fwd launches a forward and
    five gru_bwd launches a backward."""
    from cross_patient_speech_decoding_tpu_torch.models import Seq2SeqRNN

    model = Seq2SeqRNN(3, 5, 12, 5, kernel_size=4, cnn_dropout=0.0,
                       rnn_dropout=0.0, seed=0, device="cpu")
    g = torch.Generator().manual_seed(0)
    x = torch.randn((6, 16, 3), generator=g)
    y = torch.randint(0, 5, (6, 3), generator=g)

    def run():
        dev = model.device
        model.eval()
        with torch.no_grad():
            logits = model(x.to(dev), None, 0.0).cpu()
        model.train()
        state = [b.clone() for b in model.buffers()]
        out = model(x.to(dev), y.to(dev), 1.0)
        loss = torch.nn.functional.cross_entropy(out.reshape(-1, 5),
                                                 y.to(dev).reshape(-1))
        grads = [p.cpu() for p in torch.autograd.grad(
            loss, list(model.parameters()))]
        for b, s in zip(model.buffers(), state):
            b.copy_(s)
        return logits, grads

    want = run()
    model.to(card)
    gru.reset_launch_counts()
    got = run()
    assert gru.LAUNCHES == {"gru_fwd": 6, "gru_wfwd": 0, "gru_bifwd": 2,
                            "gru_bwd": 5, "gru_wbwd": 0}
    torch.testing.assert_close(got[0], want[0], atol=ATOL, rtol=0)
    names = [n for n, _ in model.named_parameters()]
    scale = {n: float(b.abs().max()) for n, b in zip(names, want[1])}
    scale["conv.bias"] = scale["conv.weight"]
    for n, a, b in zip(names, got[1], want[1]):
        torch.testing.assert_close(a, b, atol=1e-4 * scale[n], rtol=0,
                                   msg=n)


def _sym(seed, b, k, cond=50.0):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(b, k, k)))
    w = np.exp(rng.uniform(0, np.log(cond), (b, k)))
    return ((q * w[:, None, :]) @ np.swapaxes(q, 1, 2)).astype(np.float32)


def _corr(seed, b, k):
    x = np.random.default_rng(seed).normal(size=(b, k, 3 * k))
    return np.stack([np.corrcoef(a) for a in x]).astype(np.float32)


@pytest.mark.parametrize("sweeps", [1, 8])
@pytest.mark.parametrize("B,K,kind", [(256, 40, "sym"), (128, 40, "sym"),
                                      (17, 41, "sym"), (300, 13, "sym"),
                                      (1, 64, "sym"), (32, 8, "corr")])
def test_jacobi_kernel_matches_plain(card, B, K, kind, sweeps):
    A = (_sym if kind == "sym" else _corr)(7, B, K)
    Ap, _, _ = jacobi._pad_odd(torch.from_numpy(A).to(card))
    Ap = Ap.contiguous()
    pairs = jacobi._pairs_on(Ap.shape[-1], card)
    jacobi.reset_launch_counts()
    w, V, n = jacobi.jacobi_eigh_cuda(Ap, sweeps)
    w_p, V_p, n_p = jacobi.jacobi_eigh_plain(Ap, pairs, sweeps)
    assert jacobi.LAUNCHES["jacobi_eigh"] == 1
    assert torch.equal(n, n_p) and int(n.max()) <= sweeps
    assert torch.equal(w, w_p) and torch.equal(V, V_p)
    if sweeps == 8:
        w_s, V_s = jacobi.jacobi_eigh_pallas(torch.from_numpy(A).to(card))
        w64 = torch.linalg.eigvalsh(torch.from_numpy(A).double())
        scale = float(w64.abs().max())
        torch.testing.assert_close(w_s.cpu().double(), w64,
                                   atol=2e-4 * scale, rtol=0)
        rec = V_s @ (w_s[..., None] * V_s.mT)
        torch.testing.assert_close(rec.cpu(), torch.from_numpy(A),
                                   atol=2e-4 * scale, rtol=0)
        eye = torch.eye(K, device=card).expand(B, K, K)
        torch.testing.assert_close(V_s.mT @ V_s, eye, atol=5e-5, rtol=0)


@pytest.mark.parametrize("B", [1, 133])
@pytest.mark.parametrize("Kp", range(2, jacobi.MAX_K + 1, 2))
def test_jacobi_kernel_every_kp(card, Kp, B):
    """Every Kp the kernel takes launches its own instance, bit for bit
    equal to the plain version, at one matrix and at more CTAs than the
    card's 132 SMs."""
    A = torch.from_numpy(_sym(Kp, B, Kp)).to(card)
    pairs = jacobi._pairs_on(Kp, card)
    got = jacobi.jacobi_eigh_cuda(A)
    want = jacobi.jacobi_eigh_plain(A, pairs)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_jacobi_kernel_repeats_bitwise(card):
    """Two launches on the same input: w, V and sweep counts equal bit for
    bit (no atomics, a fixed reduction order)."""
    A = torch.from_numpy(_sym(3, 256, 40)).to(card)
    pairs = jacobi._pairs_on(40, card)
    got = jacobi.jacobi_eigh_cuda(A)
    again = jacobi.jacobi_eigh_cuda(A)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


def test_batched_eigh_launches_the_kernel(card):
    """The route of batched_eigh: the kernel from MIN_BATCH matrices, and
    at any batch from K = ANY_BATCH_K; torch.linalg.eigh below both and
    above K = 64."""
    n, k = jacobi.MIN_BATCH, jacobi.ANY_BATCH_K
    A = torch.from_numpy(_sym(8, 2 * n, 40)).to(card)
    jacobi.reset_launch_counts()
    jacobi.batched_eigh(A)
    jacobi.batched_eigh(A.reshape(2, n, 40, 40))
    assert jacobi.LAUNCHES["jacobi_eigh"] == 2
    jacobi.batched_eigh(A[:1])  # one matrix, K >= ANY_BATCH_K
    assert jacobi.LAUNCHES["jacobi_eigh"] == 3
    small = torch.from_numpy(_sym(8, n, k - 1)).to(card)
    jacobi.batched_eigh(small[:n - 1])  # too few matrices: linalg.eigh
    jacobi.batched_eigh(torch.from_numpy(_sym(8, n, 65)).to(card))
    assert jacobi.LAUNCHES["jacobi_eigh"] == 3
    jacobi.batched_eigh(small)
    assert jacobi.LAUNCHES["jacobi_eigh"] == 4


def test_jacobi_wrapper_raises_instead_of_falling_back(card):
    A = torch.eye(8, device=card).expand(4, 8, 8).contiguous()
    with pytest.raises(ValueError, match="CUDA tensor"):
        jacobi.jacobi_eigh_cuda(A.cpu())
    with pytest.raises(TypeError, match="float32"):
        jacobi.jacobi_eigh_cuda(A.double())
    with pytest.raises(ValueError, match="even"):
        jacobi.jacobi_eigh_cuda(torch.zeros((2, 9, 9), device=card))
    with pytest.raises(ValueError, match="even"):
        jacobi.jacobi_eigh_cuda(torch.zeros((2, 66, 66), device=card))
    with pytest.raises(ValueError, match="contiguous"):
        jacobi.jacobi_eigh_cuda(A.mT)
    with pytest.raises(ValueError, match="sweeps"):
        jacobi.jacobi_eigh_cuda(A, -1)


def _pairs_of_trials(seed, B=16, N=30, T=10, K=8, C=5, noise=0.3):
    """Flat (B, N, T*K) trials of two views sharing a K-dim latent."""
    rng = np.random.default_rng(seed)
    latent = rng.normal(size=(C, T, K))
    ids = np.broadcast_to(np.arange(N) % C, (B, N)).astype(np.int32)
    views = []
    for _ in range(2):
        mix = rng.normal(size=(B, K, K))
        x = np.einsum("bntl,blk->bntk", latent[ids], mix)
        x = x + noise * rng.normal(size=x.shape)
        views.append(torch.from_numpy(x.reshape(B, N, T * K).astype(
            np.float32)))
    return views, torch.from_numpy(ids)


@pytest.mark.parametrize("method,launches", [("chol", 1), ("gram", 2),
                                             ("svd", 0)])
def test_fit_cca_aligner_on_card_matches_cpu(card, method, launches):
    # K = 8: batched_eigh takes the kernel from MIN_BATCH pairs
    (xa, xb), ids = _pairs_of_trials(9, B=jacobi.MIN_BATCH)
    want = cca.fit_cca_aligner(xa, xb, ids, ids, 5, method=method, t_len=10)
    jacobi.reset_launch_counts()
    got = cca.fit_cca_aligner(xa.to(card), xb.to(card), ids.to(card),
                              ids.to(card), 5, method=method, t_len=10)
    assert jacobi.LAUNCHES["jacobi_eigh"] == launches
    got_a, want_a = got.alignment, want.alignment
    assert torch.equal(got_a.d.cpu(), want_a.d)
    torch.testing.assert_close(got_a.canon_corrs.cpu(), want_a.canon_corrs,
                               atol=1e-4, rtol=0)
    for name in ("proj_b_to_a", "proj_a_to_b"):
        w = getattr(want_a, name)
        torch.testing.assert_close(getattr(got_a, name).cpu(), w,
                                   atol=1e-3 * float(w.abs().max()), rtol=0)
