"""Batched symmetric eigensolver by parallel (round-robin) Jacobi rotations.

Port of ``cross_patient_speech_decoding_tpu/ops/jacobi.py``. A sweep is
Kp-1 steps of a round-robin tournament; each step rotates Kp/2 disjoint
pairs (p, q) at once, A <- R^T A R and V <- V R, so a sweep covers all
Kp(Kp-1)/2 pairs. Odd K is padded with a unit diagonal entry that never
mixes, and stripped after.

- :func:`jacobi_eigh`: the fixed-sweep mirror of the JAX ``jacobi_eigh``
  (dense rotation matrices, symmetrised after each step).
- :func:`jacobi_eigh_plain` and :func:`jacobi_eigh_cuda`: one function, as
  plain PyTorch and as the hand-written kernel of ``csrc/jacobi.cu`` (port
  of ``sweep_kernel``). Each step rotates the columns p, q of A and V and
  then the rows p, q of A. Before each sweep a matrix whose off-diagonal
  square-sum is at or under 5e-14 x max(||A0||_F^2, 1e-30) stops; the
  count of sweeps each matrix ran comes back with w and V. The kernel
  runs the tournament of ``_round_robin_pairs`` by position and is bit
  for bit the plain version with that table.
- :func:`jacobi_eigh_pallas`: the port of the JAX entry point: pads, runs
  the kernel on CUDA tensors (the plain version on CPU tensors), sorts
  ascending and strips the padding.
- :func:`batched_eigh`: the JAX dispatch, with CUDA in the TPU's place
  and the route measured on the H100 (``ANY_BATCH_K``, ``MIN_BATCH``).

Three intended differences from the JAX package:

- At tau == 0 (equal diagonal entries) the rotation takes sign(tau) = +1,
  t = 1/(1+sqrt(2)), the textbook rule. ``jnp.sign(0)`` is 0 there, so the
  JAX solver never rotates such a pair and returns a correlation matrix
  unchanged.
- Each matrix stops at its own tolerance. The JAX loop goes on rotating
  every matrix until the whole batch has converged (``jnp.any``); past its
  tolerance a matrix moves only at rounding level.
- The route. The JAX dispatch takes its kernel only for a batch of 16 or
  more (a TPU threshold: a vmapped grid runs serially). Here a CUDA batch
  takes it from ``MIN_BATCH`` matrices below K = ``ANY_BATCH_K`` and at
  any size from there (the H100's crossover), so a fit of a
  single pair by 'chol' or 'gram' solves its Gram SVD (a batch of 1) and
  the 'gram' whitening (a batch of 2) by Jacobi, at most 8 sweeps in
  float32, where JAX calls ``eigh``. ``chip_smoke.py``'s alignment phase
  (``unbatched``) holds such fits to the float64 oracle within the
  batched fits' bounds.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cross_patient_speech_decoding_tpu_torch.ops.precision import hdot
from cross_patient_speech_decoding_tpu_torch.utils.profiling import annotate

# launches of the kernel wrapper (one per solve of a batch)
LAUNCHES = {"jacobi_eigh": 0}

# the sizes the kernel takes (Kp <= 64), and where batched_eigh sends a
# CUDA batch to it: at every batch from K = ANY_BATCH_K, from MIN_BATCH
# matrices below. Measured on the H100 (tools/port_probes.py route; PERF.md
# section 7): at batch 1-16 the kernel's route beats torch.linalg.eigh at
# every K of 24 to 64 (by 1.1-45x); at K 8-16 both take 0.2-0.4 ms of
# host time, and the kernel's route loses up to batch 64 and wins or ties
# from 128 (the JAX dispatch's 16 is the TPU's threshold).
MAX_K = 64
MIN_BATCH = 128
ANY_BATCH_K = 24

# stop when the off-diagonal square-sum is at most REL_TOL * ||A0||_F^2
REL_TOL = 5e-14
SMALL = 1e-30


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _round_robin_pairs(k: int) -> np.ndarray:
    """(k-1, k/2, 2) int32: the pairs (p, q) of each step, p the member
    with sign +1 (the JAX package's tournament, jacobi.py:42-55)."""
    if k % 2:
        raise ValueError(f"round-robin schedule needs an even size, got {k}")
    players = list(range(k))
    pairs = np.zeros((k - 1, k // 2, 2), np.int32)
    for t in range(k - 1):
        for i in range(k // 2):
            pairs[t, i] = players[i], players[k - 1 - i]
        players = [players[0]] + [players[-1]] + players[1:-1]
    return pairs


@functools.lru_cache(maxsize=16)
def _round_robin_schedule(k: int):
    """Static tables: P (k-1, k, k) pair permutations, sign (k-1, k)."""
    pairs = _round_robin_pairs(k)
    perms = np.zeros((k - 1, k, k), np.float32)
    signs = np.zeros((k - 1, k), np.float32)
    for t in range(k - 1):
        for p, q in pairs[t]:
            perms[t, p, q] = perms[t, q, p] = 1.0
            signs[t, p], signs[t, q] = 1.0, -1.0
    return perms, signs


@functools.lru_cache(maxsize=32)
def _pairs_on(k: int, device: torch.device) -> torch.Tensor:
    """The pair table on ``device``, copied there once."""
    return torch.as_tensor(_round_robin_pairs(k), device=device)


def _pad_odd(A):
    K = A.shape[-1]
    if K % 2 == 0:
        return A, K, False
    A = torch.nn.functional.pad(A, (0, 1, 0, 1))
    A[..., K, K] = 1.0
    return A, K, True


def _strip_pad(w, V, K):
    """Drop the padded eigenpair: its eigenvector is exactly e_K (the
    padded coordinate never mixes, all its off-diagonals stay 0)."""
    is_pad = (V[..., K, :].abs() > 0.5).to(torch.uint8)
    idx = torch.argsort(is_pad, dim=-1, stable=True)[..., :K]
    w = torch.take_along_dim(w, idx, dim=-1)
    V = torch.take_along_dim(V[..., :K, :], idx[..., None, :], dim=-1)
    return w, V


def _sort_ascending(w, V):
    order = torch.argsort(w, dim=-1, stable=True)
    return (torch.take_along_dim(w, order, dim=-1),
            torch.take_along_dim(V, order[..., None, :], dim=-1))


def _rotation_t(tau, small):
    """t = sign(tau) / (|tau| + sqrt(1 + tau^2)) with sign(0) = +1, and
    t = 0 where the pair's off-diagonal entry is below SMALL."""
    sgn = torch.where(tau < 0, -1.0, 1.0)
    t = sgn / (tau.abs() + torch.sqrt(1.0 + tau * tau))
    return torch.where(small, 0.0, t)


# ---------------------------------------------------------------------------
# fixed-sweep mirror of the JAX jacobi_eigh
# ---------------------------------------------------------------------------


def _rotation(A_cur, P, sign, eye):
    diag = torch.diagonal(A_cur, dim1=-2, dim2=-1)
    a_partner = hdot(diag[..., None, :], P)[..., 0, :]  # P symmetric
    a_pq = (A_cur * P).sum(-1)
    small = a_pq.abs() < SMALL
    tau = sign * (a_partner - diag) / (2.0 * torch.where(small, 1.0, a_pq))
    t = _rotation_t(tau, small)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    s_full = sign * t * c
    return eye * c[..., None, :] + P * s_full[..., :, None]


def jacobi_eigh(A: torch.Tensor, sweeps: int = 8):
    """Eigendecomposition of symmetric A (..., K, K) by ``sweeps`` full
    sweeps. Returns (w, V), eigenvalues ascending, A ~ V diag(w) V^T."""
    A, K, odd = _pad_odd(A)
    Kp = A.shape[-1]
    perms, signs = _round_robin_schedule(Kp)
    P_all = torch.as_tensor(perms, dtype=A.dtype, device=A.device)
    s_all = torch.as_tensor(signs, dtype=A.dtype, device=A.device)
    eye = torch.eye(Kp, dtype=A.dtype, device=A.device)
    V = eye.expand(A.shape).clone()
    for _ in range(sweeps):
        for P, sign in zip(P_all, s_all):
            R = _rotation(A, P, sign, eye)
            A = hdot(R.mT, hdot(A, R))
            A = 0.5 * (A + A.mT)
            V = hdot(V, R)
    w, V = _sort_ascending(torch.diagonal(A, dim1=-2, dim2=-1), V)
    if odd:
        w, V = _strip_pad(w, V, K)
    return w, V


# ---------------------------------------------------------------------------
# the kernel's function: plain version and wrapper
# ---------------------------------------------------------------------------


def _tolerance(A):
    """Per-matrix stopping tolerance, in float64."""
    total = (A.double() ** 2).sum((-2, -1))
    return total.clamp(min=SMALL) * REL_TOL


def _off_mass(A, off_diag):
    """Masked off-diagonal square-sum in float64. Not ||A||^2 - ||diag||^2,
    which cancels in float32 near convergence (jacobi.py:338-343)."""
    x = A.double() * off_diag
    return (x * x).sum((-2, -1))


def _rotate_cols(M, p, q, c, s):
    """Columns p, q of M (B, Kp, Kp) <- (c x - s y, c y + s x)."""
    x, y = M[:, :, p], M[:, :, q]
    c, s = c[:, None, :], s[:, None, :]
    M[:, :, p] = c * x - s * y
    M[:, :, q] = c * y + s * x


def _rotate_rows(M, p, q, c, s):
    x, y = M[:, p, :], M[:, q, :]
    c, s = c[:, :, None], s[:, :, None]
    M[:, p, :] = c * x - s * y
    M[:, q, :] = c * y + s * x


def jacobi_eigh_plain(A: torch.Tensor, pairs: torch.Tensor, sweeps: int = 8):
    """Plain PyTorch version of the ``jacobi_eigh`` kernel.

    Args:
        A: (B, Kp, Kp) float32 symmetric, Kp even.
        pairs: (Kp-1, Kp/2, 2) int32 round-robin pairs (p, q).
        sweeps: most sweeps a matrix runs.

    Returns:
        (w (B, Kp) the unsorted diagonal, V (B, Kp, Kp), n_sweeps (B,)
        int32). A matrix stops before a sweep once its off-diagonal
        square-sum is at or under its tolerance; here the sweep is computed
        for every matrix and thrown away for those that stopped.
    """
    B, Kp, _ = A.shape
    A = A.clone()
    eye = torch.eye(Kp, dtype=A.dtype, device=A.device)
    V = eye.expand(B, Kp, Kp).clone()
    off_diag = (1.0 - eye).double()
    tol = _tolerance(A)
    n_sweeps = torch.zeros(B, dtype=torch.int32, device=A.device)
    idx = pairs.long()
    for _ in range(sweeps):
        active = _off_mass(A, off_diag) > tol
        A_old, V_old = A.clone(), V.clone()
        for step in idx:
            p, q = step[:, 0], step[:, 1]
            app, aqq, apq = A[:, p, p], A[:, q, q], A[:, p, q]
            small = apq.abs() < SMALL
            tau = (aqq - app) / (2.0 * torch.where(small, 1.0, apq))
            t = _rotation_t(tau, small)
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = t * c
            _rotate_cols(A, p, q, c, s)
            _rotate_cols(V, p, q, c, s)
            _rotate_rows(A, p, q, c, s)
        keep = active[:, None, None]
        A = torch.where(keep, A, A_old)
        V = torch.where(keep, V, V_old)
        n_sweeps += active.to(torch.int32)
    return torch.diagonal(A, dim1=-2, dim2=-1).clone(), V, n_sweeps


def _check_kernel_args(A, sweeps: int):
    if A.device.type != "cuda":
        raise ValueError(f"jacobi_eigh kernel needs a CUDA tensor, got "
                         f"{A.device}")
    if A.dtype != torch.float32:
        raise TypeError(f"A must be float32, got {A.dtype}")
    if A.dim() != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"A must be (B, Kp, Kp), got {tuple(A.shape)}")
    Kp = A.shape[-1]
    if Kp % 2 or not 2 <= Kp <= MAX_K:
        raise ValueError(f"Kp must be even and in [2, {MAX_K}], got {Kp}")
    if not A.is_contiguous():
        raise ValueError("A must be contiguous")
    if sweeps < 0:
        raise ValueError(f"sweeps must be >= 0, got {sweeps}")


def jacobi_eigh_cuda(A: torch.Tensor, sweeps: int = 8):
    """Launch the ``jacobi_eigh`` kernel (port of ``sweep_kernel``): one
    CTA per matrix, the whole solve in one launch. Result as
    :func:`jacobi_eigh_plain` with the pairs of
    ``_round_robin_pairs(Kp)``, which the kernel forms in closed form."""
    from cross_patient_speech_decoding_tpu_torch.ops import _ext

    _check_kernel_args(A, sweeps)
    B, Kp, _ = A.shape
    w = torch.empty((B, Kp), dtype=torch.float32, device=A.device)
    V = torch.empty((B, Kp, Kp), dtype=torch.float32, device=A.device)
    n_sweeps = torch.empty(B, dtype=torch.int32, device=A.device)
    if B == 0:
        return w, V, n_sweeps
    with annotate("jacobi_eigh", device=A.device, batch=B, K=Kp,
                  sweeps=sweeps), torch.cuda.device(A.device):
        err = _ext.lib().jacobi_eigh_f32(
            A.data_ptr(), w.data_ptr(), V.data_ptr(), n_sweeps.data_ptr(), B,
            Kp, sweeps,
            torch.cuda.current_stream().cuda_stream,
        )
    _ext.check(err, "jacobi_eigh_f32")
    LAUNCHES["jacobi_eigh"] += 1
    return w, V, n_sweeps


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _route(A) -> str:
    """The solver for a batch A: 'kernel' (CUDA), or 'library'
    (``torch.linalg.eigh``; CPU) in :func:`batched_eigh`, where a Jacobi
    solve of a CPU batch runs the plain version. Tests and chip_smoke.py
    replace it, returning 'plain' to send a batch down the kernel's route
    to :func:`jacobi_eigh_plain`."""
    if A.device.type == "cuda":
        return "kernel"
    if A.device.type == "cpu":
        return "library"
    raise ValueError(f"unsupported device {A.device}")


def jacobi_eigh_pallas(A: torch.Tensor, sweeps: int = 8):
    """Jacobi eigh of symmetric A (..., K, K), K <= 64: the kernel on a
    CUDA tensor, the plain version on a CPU tensor. Returns (w, V),
    eigenvalues ascending."""
    lead = A.shape[:-2]
    K = A.shape[-1]
    A3 = A.reshape(-1, K, K)
    A3, K, odd = _pad_odd(A3)
    Kp = A3.shape[-1]
    if _route(A3) == "kernel":
        w, V, _ = jacobi_eigh_cuda(A3.contiguous(), sweeps)
    else:
        w, V, _ = jacobi_eigh_plain(A3, _pairs_on(Kp, A3.device), sweeps)
    w, V = _sort_ascending(w, V)
    if odd:
        w, V = _strip_pad(w, V, K)
    return w.reshape(lead + (K,)), V.reshape(lead + (K, K))


def symmetric_eigh(A: torch.Tensor):
    """``torch.linalg.eigh`` of 0.5 (A + A^T): ``jnp.linalg.eigh``
    symmetrises its input, torch reads only the lower triangle."""
    return torch.linalg.eigh(0.5 * (A + A.mT))


def batched_eigh(A: torch.Tensor, sweeps: int = 8):
    """eigh dispatch: the Jacobi kernel for a CUDA batch (leading dims
    flattened) with K <= MAX_K of any size from K = ANY_BATCH_K, of at
    least MIN_BATCH matrices below; :func:`symmetric_eigh` for everything
    else."""
    lead = int(np.prod(A.shape[:-2])) if A.dim() > 2 else 1
    K = A.shape[-1]
    if (_route(A) in ("kernel", "plain") and K <= MAX_K
            and (lead >= MIN_BATCH or K >= ANY_BATCH_K)):
        return jacobi_eigh_pallas(A, sweeps=sweeps)
    return symmetric_eigh(A)
