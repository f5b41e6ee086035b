"""The port's Jacobi eigensolver against the JAX package's.

The same float32 symmetric matrices, made with numpy, go through the JAX
``jacobi_eigh`` / ``jacobi_eigh_pallas(interpret=True)`` and the port's
``jacobi_eigh`` / ``jacobi_eigh_pallas`` (on CPU tensors the plain version
of the CUDA kernel). Bounds are those of tests/test_jacobi.py: eigenvalues
and reconstruction within 2e-4 x max|w| of float64 ``eigvalsh``, V^T V
within 5e-5 of I; the mixed-scale batch reconstructs within 5e-6 x its
scale. After one sweep the two packages agree elementwise within
1e-5 x ||A||_F: they rotate the same pairs in the same order, rounded in
other places (dense products there, Givens updates here).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_patient_speech_decoding_tpu.ops import jacobi as jjac
from cross_patient_speech_decoding_tpu_torch.ops import jacobi

torch.set_num_threads(2)

EIG_RTOL = 2e-4
ORTH_ATOL = 5e-5
SWEEP1_RTOL = 1e-5


def _sym(rng, b, k, cond=50.0):
    # tests/test_jacobi.py:_sym
    q, _ = np.linalg.qr(rng.normal(size=(b, k, k)))
    w = np.exp(rng.uniform(0, np.log(cond), (b, k)))
    return ((q * w[:, None, :]) @ np.swapaxes(q, 1, 2)).astype(np.float32)


def _corr(rng, b, k):
    """Correlation matrices: unit diagonal, so every pair starts at tau 0."""
    x = rng.normal(size=(b, k, 3 * k))
    return np.stack([np.corrcoef(a) for a in x]).astype(np.float32)


def _check_eigh(A, w, V):
    """Eigenvalues vs float64, reconstruction and orthonormality."""
    w, V = np.asarray(w, np.float64), np.asarray(V, np.float64)
    w64 = np.linalg.eigvalsh(A.astype(np.float64))
    scale = np.abs(w64).max()
    np.testing.assert_allclose(w, w64, atol=EIG_RTOL * scale, rtol=0)
    rec = V @ (w[..., None] * np.swapaxes(V, -1, -2))
    np.testing.assert_allclose(rec, A, atol=EIG_RTOL * scale, rtol=0)
    eye = np.swapaxes(V, -1, -2) @ V
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(A.shape[-1]),
                                                    eye.shape),
                               atol=ORTH_ATOL, rtol=0)


@pytest.mark.parametrize("k", [8, 40, 41])
def test_jacobi_eigh_matches_jax(k):
    A = _sym(np.random.default_rng(0), 6, k)
    w_j, V_j = jjac.jacobi_eigh(jnp.asarray(A), sweeps=12)
    w_d, V_d = jacobi.jacobi_eigh(torch.from_numpy(A), sweeps=12)
    w_p, V_p = jacobi.jacobi_eigh_pallas(torch.from_numpy(A), sweeps=12)
    for w, V in ((w_j, V_j), (w_d, V_d), (w_p, V_p)):
        _check_eigh(A, w, V)
    scale = np.abs(np.asarray(w_j)).max()
    np.testing.assert_allclose(w_d.numpy(), np.asarray(w_j),
                               atol=EIG_RTOL * scale, rtol=0)
    np.testing.assert_allclose(w_p.numpy(), np.asarray(w_j),
                               atol=EIG_RTOL * scale, rtol=0)


@pytest.mark.parametrize("B,K", [(6, 8), (5, 13)])
def test_plain_matches_jax_pallas_interpret(B, K):
    """The kernel's plain version against the Pallas kernel in interpret
    mode (the inputs of tests/test_jacobi.py:80-97)."""
    rng = np.random.default_rng(0)
    M = rng.normal(size=(B, K, K)).astype(np.float32)
    A = M @ M.transpose(0, 2, 1) + np.eye(K, dtype=np.float32)
    w_j, V_j = jjac.jacobi_eigh_pallas(jnp.asarray(A), block=4,
                                       interpret=True)
    w_p, V_p = jacobi.jacobi_eigh_pallas(torch.from_numpy(A))
    _check_eigh(A, w_p, V_p)
    scale = np.abs(np.asarray(w_j)).max()
    np.testing.assert_allclose(w_p.numpy(), np.asarray(w_j),
                               atol=EIG_RTOL * scale, rtol=0)
    # eigenvectors up to sign: the projectors V V^T agree
    pj = np.asarray(V_j) @ np.swapaxes(np.asarray(V_j), 1, 2)
    pp = V_p.numpy() @ np.swapaxes(V_p.numpy(), 1, 2)
    np.testing.assert_allclose(pp, pj, atol=ORTH_ATOL, rtol=0)


@pytest.mark.parametrize("pallas", [False, True])
def test_heterogeneous_scale_batch(pallas):
    """tests/test_jacobi.py:54-77: a small matrix batched with a 1e4x
    larger near-diagonal one must not stop on its batchmate's tolerance;
    the port stops each matrix on its own."""
    rng = np.random.default_rng(7)
    K = 8
    small = _sym(rng, 1, K)[0]
    big = (1e4 * (np.diag(rng.uniform(1, 2, K))
                  + 1e-6 * _sym(rng, 1, K)[0])).astype(np.float32)
    A = np.stack([small, (big + big.T) / 2])
    if pallas:
        w, V = jjac.jacobi_eigh_pallas(jnp.asarray(A), block=2,
                                       interpret=True)
        w, V = np.asarray(w), np.asarray(V)
    else:
        w, V = (t.numpy() for t in jacobi.jacobi_eigh_pallas(
            torch.from_numpy(A)))
    for i in range(2):
        rec = V[i] @ (w[i][:, None] * V[i].T)
        scale = np.abs(np.linalg.eigvalsh(A[i].astype(np.float64))).max()
        np.testing.assert_allclose(rec, A[i], atol=5e-6 * scale, rtol=0)


def _one_sweep_cases():
    return [("dense", 8), ("dense", 40), ("plain", 8), ("plain", 40),
            ("interpret", 8), ("interpret", 13)]


@pytest.mark.parametrize("port,k", _one_sweep_cases())
def test_one_sweep_matches_jax_elementwise(port, k):
    """sweeps=1: the same rotations in the same order. 'dense' and
    'plain' hold the port's jacobi_eigh and jacobi_eigh_pallas against JAX
    jacobi_eigh; 'interpret' the plain version against the Pallas kernel
    in interpret mode (small K: interpret mode is slow)."""
    A = _sym(np.random.default_rng(3), 4, k)
    if port == "interpret":
        w_j, V_j = jjac.jacobi_eigh_pallas(jnp.asarray(A), sweeps=1, block=4,
                                           interpret=True)
    else:
        w_j, V_j = jjac.jacobi_eigh(jnp.asarray(A), sweeps=1)
    fn = jacobi.jacobi_eigh if port == "dense" else jacobi.jacobi_eigh_pallas
    w, V = fn(torch.from_numpy(A), sweeps=1)
    tol = SWEEP1_RTOL * np.linalg.norm(A, axis=(1, 2))
    assert (np.abs(w.numpy() - np.asarray(w_j)).max(-1) <= tol).all()
    assert (np.abs(V.numpy() - np.asarray(V_j)).max((-2, -1)) <= tol).all()


def test_odd_k_is_padded_and_stripped():
    A = _sym(np.random.default_rng(4), 3, 13)
    At = torch.from_numpy(A)
    Ap, K, odd = jacobi._pad_odd(At)
    assert odd and K == 13 and Ap.shape == (3, 14, 14)
    assert torch.equal(Ap[:, :13, :13], At)
    assert (Ap[:, 13, 13] == 1).all() and (Ap[:, 13, :13] == 0).all()
    w, V = jacobi.jacobi_eigh_pallas(At)
    assert w.shape == (3, 13) and V.shape == (3, 13, 13)
    _check_eigh(A, w, V)
    # 2-D input: no batch axis in or out
    w2, V2 = jacobi.jacobi_eigh_pallas(At[1])
    assert w2.shape == (13,) and torch.equal(w2, w[1])
    # leading dims are flattened and restored
    w4, _ = jacobi.jacobi_eigh_pallas(At.reshape(1, 3, 13, 13))
    assert w4.shape == (1, 3, 13) and torch.equal(w4[0], w)


def test_schedule_matches_jax():
    for k in (2, 8, 14, 42):
        perms, signs = jjac._round_robin_schedule(k)
        p2, s2 = jacobi._round_robin_schedule(k)
        np.testing.assert_array_equal(p2, perms)
        np.testing.assert_array_equal(s2, signs)
        pairs = jacobi._round_robin_pairs(k)
        assert pairs.shape == (k - 1, k // 2, 2)
        # every unordered pair exactly once per sweep
        seen = {tuple(sorted(p)) for p in pairs.reshape(-1, 2).tolist()}
        assert len(seen) == k * (k - 1) // 2


def _player(kp, t, pos):
    """The player at position pos of the tournament at step t: player i
    starts at position i, and between steps the players at positions
    1 .. Kp-1 move on by one (Kp-1 to 1)."""
    x = pos - 1 - t
    return 0 if pos == 0 else 1 + (x + kp - 1 if x < 0 else x)


def _fold(kp, pos):
    """csrc/jacobi.cu:fold: position j < Kp/2 at index 2j, Kp-1-j at 2j+1."""
    return 2 * pos if pos < kp // 2 else 2 * (kp - 1 - pos) + 1


def _moved(kp, f):
    """csrc/jacobi.cu:moved: the folded index the element at f moves to."""
    pos = kp - 1 - f // 2 if f % 2 else f // 2
    return _fold(kp, 0 if pos == 0 else 1 if pos == kp - 1 else pos + 1)


@pytest.mark.parametrize("kp", range(2, 65, 2))
def test_kernel_tournament_by_position_is_the_table(kp):
    """The kernel runs the round-robin tournament by position: pair j of
    every step is the players at positions j and Kp-1-j, and the players
    at positions 1 .. Kp-1 move on by one between steps. That is
    _round_robin_pairs(Kp), the table the plain version takes; after the
    Kp-1 steps of a sweep every player is back at its position (the V
    lanes' registers and the folded A rely on it); and the folded index
    moves as the players do."""
    table = jacobi._round_robin_pairs(kp)
    form = np.array([[(_player(kp, t, j), _player(kp, t, kp - 1 - j))
                      for j in range(kp // 2)] for t in range(kp - 1)])
    np.testing.assert_array_equal(form, table)
    assert [_player(kp, kp - 1, pos) for pos in range(kp)] == list(range(kp))
    assert sorted(_fold(kp, pos) for pos in range(kp)) == list(range(kp))
    for t in range(kp - 1):
        for pos in range(kp):
            now = _player(kp, t, pos)
            nxt = next(q for q in range(kp)
                       if _player(kp, (t + 1) % (kp - 1), q) == now)
            assert _moved(kp, _fold(kp, pos)) == _fold(kp, nxt)


def _kernel_step_mirror(A, pairs, sweeps):
    """The CUDA kernel's step (csrc/jacobi.cu), in float32 tensor ops in
    its order, on its layout: A held by tournament position and folded
    (pair j's positions at indices 2j and 2j+1), in two buffers; each
    lane's c and s from the buffer the step reads, each (row pair k,
    column pair l) 2x2 block rotated by columns (pair l), then by rows
    (pair k), and written into the other buffer where its players stand
    next, every element once; V one sweep behind A, from the c and s the
    sweep recorded, its columns by position (pair j at positions j and
    Kp-1-j, positions 1 .. Kp-1 moving on by one a step), as the kernel's
    V lanes hold their rows in registers. Per-matrix stop as the plain
    version. ``pairs`` only checks that it is the tournament."""
    B, Kp, _ = A.shape
    H = Kp // 2
    assert torch.equal(pairs, torch.from_numpy(jacobi._round_robin_pairs(Kp)))
    fold = torch.tensor([_fold(Kp, pos) for pos in range(Kp)])
    unfold = torch.argsort(fold)
    moved = torch.tensor([_moved(Kp, f) for f in range(Kp)])
    eye = torch.eye(Kp)
    off_diag = (1.0 - eye).double()
    tol = jacobi._tolerance(A)
    bufs = [A[:, unfold][:, :, unfold].clone(), torch.empty_like(A)]
    V = eye.expand(B, Kp, Kp).clone()
    n_sweeps = torch.zeros(B, dtype=torch.int32)
    cur = 0
    j = torch.arange(H)
    shift = torch.tensor([0, Kp - 1, *range(1, Kp - 1)][:Kp])
    k2, l2 = (2 * j)[:, None], (2 * j)[None, :]  # rows 2k, columns 2l

    def rotate_v(c, s):
        """A step on V by position: pair j is columns j and Kp-1-j."""
        nonlocal V
        x, y = V[:, :, j], V[:, :, Kp - 1 - j]
        V[:, :, j] = c[:, None, :] * x - s[:, None, :] * y
        V[:, :, Kp - 1 - j] = c[:, None, :] * y + s[:, None, :] * x
        V = V[:, :, shift]

    for _ in range(sweeps):
        active = jacobi._off_mass(bufs[cur], off_diag) > tol
        A_old, V_old = bufs[cur].clone(), V.clone()
        recorded = []
        for _ in range(Kp - 1):
            R = bufs[cur]
            W = bufs[1 - cur].fill_(float("nan"))
            app, apq = R[:, 2 * j, 2 * j], R[:, 2 * j, 2 * j + 1]
            aqq = R[:, 2 * j + 1, 2 * j + 1]
            small = apq.abs() < jacobi.SMALL
            tau = (aqq - app) / (2.0 * torch.where(small, 1.0, apq))
            r = torch.sqrt(1.0 + tau * tau)
            t = torch.where(tau < 0, -1.0, 1.0) / (tau.abs() + r)
            t = torch.where(small, 0.0, t)
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = t * c
            ck, sk = c[:, :, None], s[:, :, None]
            cl, sl = c[:, None, :], s[:, None, :]
            x1, y1 = R[:, k2, l2], R[:, k2, l2 + 1]
            x2, y2 = R[:, k2 + 1, l2], R[:, k2 + 1, l2 + 1]
            a1, b1 = cl * x1 - sl * y1, cl * y1 + sl * x1
            a2, b2 = cl * x2 - sl * y2, cl * y2 + sl * x2
            mp, mq = moved[k2], moved[k2 + 1]  # rows pk, qk move to
            np_, nq = moved[l2], moved[l2 + 1]  # columns pl, ql move to
            W[:, mp, np_] = ck * a1 - sk * a2
            W[:, mq, np_] = ck * a2 + sk * a1
            W[:, mp, nq] = ck * b1 - sk * b2
            W[:, mq, nq] = ck * b2 + sk * b1
            assert not W.isnan().any()  # the blocks cover A once
            recorded.append((c, s))
            cur = 1 - cur
        for rotation in recorded:
            rotate_v(*rotation)
        keep = active[:, None, None]
        bufs[cur] = torch.where(keep, bufs[cur], A_old)
        V = torch.where(keep, V, V_old)
        n_sweeps += active.to(torch.int32)
    A_end = bufs[cur][:, fold][:, :, fold]
    return torch.diagonal(A_end, dim1=-2, dim2=-1).clone(), V, n_sweeps


@pytest.mark.parametrize("sweeps", [1, 8])
@pytest.mark.parametrize("kp", [2, 4, 14, 40, 42, 64])
def test_kernel_step_mirror_bitwise_equals_plain(kp, sweeps):
    """The kernel's one-barrier step (2x2 blocks from one buffer into the
    other, V by (row, pair) slots one sweep late) changes who computes
    which element and when, not any element's arithmetic: its mirror is
    bit for bit the plain version, sweep counts included, on a diagonal
    matrix (0 sweeps), a dense one and a correlation matrix."""
    rng = np.random.default_rng(kp)
    A = torch.from_numpy(np.stack([
        np.diag(np.arange(1, kp + 1)).astype(np.float32),
        _sym(rng, 1, kp)[0], _corr(rng, 1, kp)[0]]))
    pairs = torch.from_numpy(jacobi._round_robin_pairs(kp))
    got = _kernel_step_mirror(A, pairs, sweeps)
    want = jacobi.jacobi_eigh_plain(A, pairs, sweeps)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[2][0] == 0 and got[2][1] >= 1


def test_batched_eigh_dispatch_on_cpu(monkeypatch):
    """CPU tensors go to torch.linalg.eigh of the symmetrised input (as
    jnp.linalg.eigh symmetrises); with the route hook returning 'plain', a
    batch of >= MIN_BATCH matrices of K <= 64, or a batch of any size from
    K = ANY_BATCH_K, takes the kernel's route to the plain version, and
    smaller or wider ones stay with eigh."""
    rng = np.random.default_rng(5)
    A = _sym(rng, 16, 8)
    A[:, 0, 1] += 1e-3  # not symmetric: the upper triangle counts too
    At = torch.from_numpy(A)
    w, V = jacobi.batched_eigh(At)
    w_s, V_s = torch.linalg.eigh(0.5 * (At + At.mT))
    assert torch.equal(w, w_s) and torch.equal(V, V_s)
    w_j, _ = jnp.linalg.eigh(jnp.asarray(A))
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), atol=1e-5 * 50)

    calls = []
    plain = jacobi.jacobi_eigh_plain

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return plain(*args, **kw)

    monkeypatch.setattr(jacobi, "_route", lambda A: "plain")
    monkeypatch.setattr(jacobi, "jacobi_eigh_plain", counted)
    n = jacobi.MIN_BATCH
    sym = torch.from_numpy(_sym(rng, n, 8))
    jacobi.batched_eigh(sym)
    jacobi.batched_eigh(sym.reshape(2, n // 2, 8, 8))
    assert calls == [(n, 8, 8), (n, 8, 8)]
    jacobi.batched_eigh(sym[:n - 1])  # batch too small
    jacobi.batched_eigh(torch.from_numpy(_sym(rng, n, 65)))  # too wide
    assert len(calls) == 2
    k = jacobi.ANY_BATCH_K
    jacobi.batched_eigh(torch.from_numpy(_sym(rng, 1, k)))  # wide enough
    jacobi.batched_eigh(torch.from_numpy(_sym(rng, n - 1, k - 1)))
    assert calls[2:] == [(1, k, k)]


def test_correlation_matrices_intended_difference():
    """Intended difference from the JAX package (sign(0) := +1). A
    correlation matrix has a unit diagonal, so every pair starts at
    tau == 0; jnp.sign(0) == 0 gives t = 0 there and the JAX solver
    returns the matrix unchanged (eigenvalues all 1, V = I). The port
    takes the textbook 45-degree rotation and matches float64 eigvalsh."""
    A = _corr(np.random.default_rng(6), 4, 8)
    w_j, V_j = jjac.jacobi_eigh(jnp.asarray(A))
    np.testing.assert_array_equal(np.asarray(w_j), 1.0)
    np.testing.assert_array_equal(np.asarray(V_j),
                                  np.broadcast_to(np.eye(8), (4, 8, 8)))
    w_i, _ = jjac.jacobi_eigh_pallas(jnp.asarray(A), block=4, interpret=True)
    np.testing.assert_array_equal(np.asarray(w_i), 1.0)
    for fn in (jacobi.jacobi_eigh, jacobi.jacobi_eigh_pallas):
        w, V = fn(torch.from_numpy(A))
        _check_eigh(A, w, V)
    w2, _ = jacobi.jacobi_eigh_pallas(torch.tensor([[1.0, 0.5], [0.5, 1.0]]))
    np.testing.assert_allclose(w2.numpy(), [0.5, 1.5], atol=1e-6)


def test_each_matrix_stops_at_its_own_tolerance():
    """Intended difference from the JAX package: JAX rotates every matrix
    until all are converged (jnp.any); the port stops each one on its own.
    A diagonal matrix runs 0 sweeps and keeps V = I exactly, beside a dense
    one that runs several; the results still match JAX."""
    rng = np.random.default_rng(8)
    A = np.stack([np.diag(np.arange(1, 9)).astype(np.float32),
                  _sym(rng, 1, 8)[0]])
    pairs = torch.from_numpy(jacobi._round_robin_pairs(8))
    w, V, n_sweeps = jacobi.jacobi_eigh_plain(torch.from_numpy(A), pairs)
    assert n_sweeps[0] == 0 and 1 < n_sweeps[1] <= 8
    assert torch.equal(V[0], torch.eye(8))
    assert torch.equal(w[0], torch.arange(1, 9, dtype=torch.float32))
    w_j, _ = jjac.jacobi_eigh_pallas(jnp.asarray(A), block=2, interpret=True)
    w_p, V_p = jacobi.jacobi_eigh_pallas(torch.from_numpy(A))
    np.testing.assert_allclose(w_p.numpy(), np.asarray(w_j),
                               atol=EIG_RTOL * 8, rtol=0)
    _check_eigh(A, w_p, V_p)
    # sweeps=0 leaves every matrix as it came
    w0, V0, n0 = jacobi.jacobi_eigh_plain(torch.from_numpy(A), pairs, 0)
    assert (n0 == 0).all() and torch.equal(V0[1], torch.eye(8))


def test_kernel_wrapper_raises_instead_of_falling_back():
    """The wrapper checks before touching the library: a CPU tensor and
    every shape or type the kernel does not take raise."""
    A = torch.eye(8).expand(4, 8, 8).contiguous()
    with pytest.raises(ValueError, match="CUDA tensor"):
        jacobi.jacobi_eigh_cuda(A)
    check = functools.partial(jacobi._check_kernel_args, sweeps=8)
    with pytest.raises(TypeError, match="float32"):
        check(_CudaLike(A.double()))
    with pytest.raises(ValueError, match="even"):
        check(_CudaLike(torch.zeros(2, 9, 9)))
    with pytest.raises(ValueError, match="even"):
        check(_CudaLike(torch.zeros(2, 66, 66)))
    with pytest.raises(ValueError, match="contiguous"):
        check(_CudaLike(torch.zeros(8, 8, 4).permute(2, 0, 1)))
    with pytest.raises(ValueError, match="sweeps"):
        jacobi._check_kernel_args(_CudaLike(A), -1)


class _CudaLike:
    """A CPU tensor that reports a CUDA device, to reach the argument
    checks after the device check here."""

    def __init__(self, t):
        self._t = t
        self.device = torch.device("cuda", 0)

    def __getattr__(self, name):
        return getattr(self._t, name)
