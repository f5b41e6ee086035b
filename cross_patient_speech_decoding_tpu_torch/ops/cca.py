"""CCA alignment of neural latent spaces, natively batched.

Port of ``cross_patient_speech_decoding_tpu/ops/cca.py`` (the math of the
reference's ``CCA_align`` / ``AlignCCA``, after Gallego et al. 2020): per-
dimension centering, rank determination, orthonormalisation, SVD of the
orthonormal-basis inner product, manifold directions M = pinv(R) U[:, :d]
and the b->a transform X M_b pinv(M_a). Same names, NamedTuples and
layouts as the JAX module:

- static widths with masking instead of data-dependent truncation
  (columns >= d zeroed; pinv([A, 0]) == [pinv(A); 0]);
- row masks for classes absent from either dataset;
- leading batch dims solved natively: on the card the Gram route's small
  SVD and eigh whitening go to the Jacobi kernel (``ops/jacobi.py``)
  once a batch holds 16 or more matrices.

Every product runs in full float32 (``ops/precision.py``), Choleskys
through ``cholesky_ex`` (no host sync; the identity padding and ridge keep
the matrices positive definite), triangular solves in full float32.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cross_patient_speech_decoding_tpu_torch.ops import jacobi
from cross_patient_speech_decoding_tpu_torch.ops.precision import (
    hdot,
    hpinv,
    true_f32,
)
from cross_patient_speech_decoding_tpu_torch.utils.device import same_device


class CCAAlignment(NamedTuple):
    """Fitted CCA alignment between datasets A and B.

    Attributes:
        m_a: (Ka, D) manifold directions for A, columns >= d zeroed.
        m_b: (Kb, D) manifold directions for B, columns >= d zeroed.
        canon_corrs: (D,) canonical correlations clipped to [0, 1], zero
            beyond d.
        d: 0-d int32 effective manifold dim: min(rank_a, rank_b), further
            reduced by singular directions the Gram-route SVD dropped.
        proj_b_to_a: (Kb, Ka) composite transform M_b @ pinv(M_a).
        proj_a_to_b: (Ka, Kb) composite transform M_a @ pinv(M_b).
    """

    m_a: torch.Tensor
    m_b: torch.Tensor
    canon_corrs: torch.Tensor
    d: torch.Tensor
    proj_b_to_a: torch.Tensor
    proj_a_to_b: torch.Tensor


def _masked_center_cols(L, row_mask):
    """Center each column over (valid) rows; zero invalid rows exactly.
    Batched: L (..., R, K), row_mask (..., R)."""
    if row_mask is None:
        return L - L.mean(-2, keepdim=True)
    w = row_mask.to(L.dtype)[..., None]
    n = w.sum(-2, keepdim=True).clamp(min=1.0)
    mean = (L * w).sum(-2, keepdim=True) / n
    return (L - mean) * w


def _rank_tol(s, n_rows, n_cols):
    """numpy matrix_rank default tolerance: smax * max(M, N) * eps, per
    matrix: s (..., K) -> (..., 1)."""
    eps = torch.finfo(s.dtype).eps
    return s.amax(-1, keepdim=True) * max(n_rows, n_cols) * eps


def _inv_or_zero(s, keep):
    return torch.where(keep, 1.0 / torch.where(keep, s, 1.0), 0.0)


def _orthonormalize(L, method: str = "svd"):
    """Orthonormal column-space basis with null directions zeroed.
    Returns (Q, pinv_R, rank) with L = Q R, R = diag(s) V^T (thin SVD)."""
    del method
    R, K = L.shape[-2], L.shape[-1]
    u, s, vt = torch.linalg.svd(L, full_matrices=False)
    tol = _rank_tol(s, R, K)
    keep = s > tol
    keep_f = keep.to(L.dtype)
    rank = keep.sum(-1).to(torch.int32)
    q = u * keep_f[..., None, :]
    pinv_r = vt.mT * (_inv_or_zero(s, keep) * keep_f)[..., None, :]
    return q, pinv_r, rank


def masked_pinv(M):
    """pinv that is exact for zero-masked trailing columns (SVD)."""
    return hpinv(M)


def _eye_like(g):
    return torch.eye(g.shape[-1], dtype=g.dtype, device=g.device)


def _fast_masked_pinv(M, col_mask):
    """pinv via the normal equations for a column-masked M: one batched
    Cholesky, identity-padded on masked and (near-)zero columns, whose pinv
    rows come out exactly zero; the live diagonal carries a 4e-7 relative
    ridge (cca.py:122-174)."""
    g = hdot(M.mT, M)
    D = g.shape[-1]
    dg = torch.diagonal(g, dim1=-2, dim2=-1)
    eps = torch.finfo(g.dtype).eps
    dmax = dg.amax(-1, keepdim=True)
    tol = dmax * (D * eps) ** 2
    eff_mask = col_mask * (dg > tol).to(g.dtype)
    mm = eff_mask[..., :, None] * eff_mask[..., None, :]
    g = g * mm + _eye_like(g) * (
        (1.0 - eff_mask) + 4e-7 * dmax * eff_mask
    )[..., None, :]
    with true_f32():
        L = torch.linalg.cholesky_ex(g).L
        z = torch.linalg.solve_triangular(L, M.mT, upper=False)
        sol = torch.linalg.solve_triangular(L.mT, z, upper=True)
    return sol * eff_mask[..., :, None]


def _whiten_chol(g, R: int):
    """Cholesky whitening of a PSD Gram matrix: W = inv(L)^T, masked
    (cca.py:177-223). Exact for latents full-rank within their column
    mask; masked or near-zero columns are identity-padded and zeroed."""
    K = g.shape[-1]
    dg = torch.diagonal(g, dim1=-2, dim2=-1)
    dmax = dg.amax(-1, keepdim=True)
    eps = torch.finfo(g.dtype).eps
    tol = dmax * (max(R, K) * eps) ** 2
    keep = dg > tol
    m = keep.to(g.dtype)
    rank = keep.sum(-1).to(torch.int32)
    eye = _eye_like(g)
    mm = m[..., :, None] * m[..., None, :]
    gp = g * mm + eye * ((1.0 - m) + 4e-7 * dmax * m)[..., None, :]
    with true_f32():
        L = torch.linalg.cholesky_ex(gp).L
        l_inv = torch.linalg.solve_triangular(L, eye.expand(L.shape),
                                              upper=False)
    W = l_inv.mT * m[..., None, :]
    return W, rank


def _svd_small(g, method: str, force_gram: bool | None = None):
    """SVD of the small between-view matrix -> (u, s, vt, keep).

    method='gram' on a CUDA tensor: eigh of g^T g through
    :func:`jacobi.batched_eigh` (the Jacobi kernel, at K >= 24 for any
    batch), U = g V / s, with near-zero singular directions zeroed and
    dropped from ``keep``. Otherwise ``torch.linalg.svd``, every direction
    kept. ``force_gram`` pins the branch (the CPU tests)."""
    use_gram = (
        method == "gram" and g.device.type == "cuda"
        if force_gram is None else force_gram
    )
    if use_gram:
        gtg = hdot(g.mT, g)
        w, v = jacobi.batched_eigh(gtg)
        s = torch.sqrt(w.flip(-1).clamp(min=0.0))
        v = v.flip(-1)
        tol = s.amax(-1, keepdim=True) * g.shape[-1] * torch.finfo(
            g.dtype).eps * 10
        keep = s > tol
        u = hdot(g, v) * _inv_or_zero(s, keep)[..., None, :]
        return u, s, v.mT, keep.to(g.dtype)
    u, s, vt = torch.linalg.svd(g, full_matrices=False)
    return u, s, vt, torch.ones_like(s)


def cca_align(
    L_a: torch.Tensor,
    L_b: torch.Tensor,
    row_mask: torch.Tensor | None = None,
    method: str = "svd",
) -> CCAAlignment:
    """CCA alignment between two latent-dynamics matrices.

    Args:
        L_a: (..., R, Ka) latent dynamics for A; rows are samples (class x
            time flattened), columns latent dims. Leading batch dims are
            solved natively.
        L_b: (..., R, Kb) latent dynamics for B (same row layout/mask).
        row_mask: optional (..., R) {0,1} validity mask shared by both.
        method: 'svd' (thin-SVD orthonormalisation), 'gram' (Gram-eigh
            whitening, rank-robust) or 'chol' (Gram-Cholesky whitening,
            exact only for inputs full-rank within their column mask).
    """
    same_device(L_a, L_b, row_mask)
    La = _masked_center_cols(L_a, row_mask)
    Lb = _masked_center_cols(L_b, row_mask)

    if method in ("gram", "chol"):
        return _cca_align_gram(La, Lb, chol=(method == "chol"))

    q_a, pinv_ra, rank_a = _orthonormalize(La, method)
    q_b, pinv_rb, rank_b = _orthonormalize(Lb, method)
    d = torch.minimum(rank_a, rank_b)

    g = hdot(q_a.mT, q_b)  # (..., Ka, Kb)
    u, s, vt, _ = _svd_small(g, "svd")
    D = s.shape[-1]  # = min(Ka, Kb)

    # prefix mask over the s-descending order: the min-rank leading block
    col_mask = (torch.arange(D, device=d.device) < d[..., None]).to(L_a.dtype)
    m_a = hdot(pinv_ra, u[..., :, :D]) * col_mask[..., None, :]
    m_b = hdot(pinv_rb, vt.mT[..., :, :D]) * col_mask[..., None, :]
    corrs = s[..., :D].clamp(0.0, 1.0) * col_mask

    proj_b_to_a = hdot(m_b, masked_pinv(m_a))
    proj_a_to_b = hdot(m_a, masked_pinv(m_b))
    return CCAAlignment(m_a, m_b, corrs, d, proj_b_to_a, proj_a_to_b)


def _cca_align_gram(La, Lb, chol: bool = False,
                    force_gram: bool | None = None) -> CCAAlignment:
    """Gram-route CCA on pre-centered latents: one Gram of [La | Lb]
    gives La^T La, Lb^T Lb and the cross-Gram; everything after is
    (K, K)-sized (cca.py:322-396). With ka == kb both whitening eighs go
    to one stacked solve."""
    ka, kb = La.shape[-1], Lb.shape[-1]
    R = La.shape[-2]
    Lab = torch.cat([La, Lb], dim=-1)  # (..., R, ka+kb)
    G = hdot(Lab.mT, Lab)
    ga = G[..., :ka, :ka]
    gb = G[..., ka:, ka:]
    gx = G[..., :ka, ka:]

    def whiten(g, K):
        if chol:
            return _whiten_chol(g, R)
        w, v = jacobi.batched_eigh(g)
        s = torch.sqrt(w.flip(-1).clamp(min=0.0))
        v = v.flip(-1)
        keep = s > _rank_tol(s, R, K)
        rank = keep.sum(-1).to(torch.int32)
        return v * (_inv_or_zero(s, keep) * keep.to(g.dtype))[..., None, :], rank

    if ka == kb:
        # both whitening eighs in one eigensolver launch
        w_ab, rank_ab = whiten(torch.stack([ga, gb], dim=0), ka)
        w_a, w_b = w_ab[0], w_ab[1]
        rank_a, rank_b = rank_ab[0], rank_ab[1]
    else:
        w_a, rank_a = whiten(ga, ka)
        w_b, rank_b = whiten(gb, kb)
    d = torch.minimum(rank_a, rank_b)

    g = hdot(w_a.mT, hdot(gx, w_b))  # == q_a^T q_b
    u, s, vt, s_keep = _svd_small(g, "gram", force_gram=force_gram)
    D = s.shape[-1]  # = min(ka, kb)

    # s_keep drops directions the Gram-route SVD zeroed: left inside
    # col_mask they would make _fast_masked_pinv's Gram singular
    col_mask = (torch.arange(D, device=d.device) < d[..., None]).to(
        La.dtype) * s_keep
    m_a = hdot(w_a, u[..., :, :D]) * col_mask[..., None, :]
    m_b = hdot(w_b, vt.mT[..., :, :D]) * col_mask[..., None, :]
    corrs = s[..., :D].clamp(0.0, 1.0) * col_mask

    proj_b_to_a = hdot(m_b, _fast_masked_pinv(m_a, col_mask))
    proj_a_to_b = hdot(m_a, _fast_masked_pinv(m_b, col_mask))
    d_eff = col_mask.sum(-1).to(torch.int32)
    return CCAAlignment(m_a, m_b, corrs, d_eff, proj_b_to_a, proj_a_to_b)


def cnd_avg(
    data: torch.Tensor,
    class_ids: torch.Tensor,
    n_classes: int,
    sample_mask: torch.Tensor | None = None,
):
    """Per-class trial means (reference ``cnd_avg``, alignment_utils.py:
    42-61), as one one-hot contraction over the trial axis, batched over
    leading dims.

    Args:
        data: (..., N, *rest) trials-first array.
        class_ids: (..., N) integer compact class ids in [0, n_classes);
            ids outside that range count for no class.
        n_classes: class-universe size.
        sample_mask: optional (..., N) validity mask.

    Returns:
        (avg, counts): avg (..., n_classes, *rest) with zero rows for
        absent classes; counts (..., n_classes) valid trials per class.
    """
    same_device(data, class_ids, sample_mask)
    lead = tuple(class_ids.shape[:-1])
    n = class_ids.shape[-1]
    rest = tuple(data.shape[len(lead) + 1:])
    classes = torch.arange(n_classes, device=class_ids.device)
    oh = (class_ids[..., None] == classes).to(data.dtype)
    if sample_mask is not None:
        oh = oh * sample_mask.to(data.dtype)[..., None]
    sums = hdot(oh.mT, data.reshape(lead + (n, -1)))  # (..., C, prod(rest))
    counts = oh.sum(-2)
    avg = sums.reshape(lead + (n_classes,) + rest) / counts.clamp(
        min=1.0).reshape(lead + (n_classes,) + (1,) * len(rest))
    return avg, counts


class FittedAligner(NamedTuple):
    """AlignCCA-equivalent fitted on class-averaged latent trajectories."""

    alignment: CCAAlignment
    shared_mask: torch.Tensor  # (..., n_classes) classes present in both


def fit_cca_aligner(
    X_a: torch.Tensor,
    X_b: torch.Tensor,
    ids_a: torch.Tensor,
    ids_b: torch.Tensor,
    n_classes: int,
    mask_a: torch.Tensor | None = None,
    mask_b: torch.Tensor | None = None,
    method: str = "chol",
    t_len: int | None = None,
) -> FittedAligner:
    """Fit class-averaged CCA alignment (reference AlignCCA type='class'):
    condition-average each dataset, keep classes present in both, fold
    time into rows, CCA.

    Args:
        X_a: (..., Na, T, Ka) target-latent trials, leading batch dims
            solved natively; with ``t_len`` set, the flat layout
            (..., Na, T*Ka).
        X_b: (..., Nb, T, Kb) source-latent trials (or (..., Nb, T*Kb)).
        ids_a, ids_b: (..., N) per-trial compact class ids.
        n_classes: class-universe size.
        mask_a, mask_b: optional per-trial validity masks.
        method: 'chol' (default), 'gram' or 'svd', as :func:`cca_align`.
        t_len: T, to accept trials in the flat layout.
    """
    same_device(X_a, X_b, ids_a, ids_b, mask_a, mask_b)
    if t_len is None:
        T = X_a.shape[-2]
        ka, kb = X_a.shape[-1], X_b.shape[-1]
    else:
        T = t_len
        ka, kb = X_a.shape[-1] // T, X_b.shape[-1] // T
    avg_a, cnt_a = cnd_avg(X_a, ids_a, n_classes, mask_a)
    avg_b, cnt_b = cnd_avg(X_b, ids_b, n_classes, mask_b)
    shared = ((cnt_a > 0) & (cnt_b > 0)).to(X_a.dtype)

    lead = tuple(ids_a.shape[:-1])
    # (C, T, K) and (C, T*K) are the same row-major data
    L_a = avg_a.reshape(lead + (n_classes * T, ka))
    L_b = avg_b.reshape(lead + (n_classes * T, kb))
    row_mask = torch.repeat_interleave(shared, T, dim=-1)

    alignment = cca_align(L_a, L_b, row_mask, method)
    return FittedAligner(alignment=alignment, shared_mask=shared)


def transform_b_to_a(aligner: FittedAligner, X_b: torch.Tensor) -> torch.Tensor:
    """Source-patient latents into the target's space, X M_b pinv(M_a)
    (AlignCCA.py:92-94)."""
    return hdot(X_b, aligner.alignment.proj_b_to_a)


def transform_a_to_b(aligner: FittedAligner, X_a: torch.Tensor) -> torch.Tensor:
    """return_space='a_to_b' (AlignCCA.py:94): X M_a pinv(M_b)."""
    return hdot(X_a, aligner.alignment.proj_a_to_b)


def transform_shared(aligner: FittedAligner, X_a, X_b):
    """return_space='shared' (AlignCCA.py:96-106): (X_a M_a, X_b M_b)."""
    return (
        hdot(X_a, aligner.alignment.m_a),
        hdot(X_b, aligner.alignment.m_b),
    )


def shared_trial_subselect_indices(ids_a, ids_b, rng):
    """Per-class random matched-trial pairing (AlignCCA.py:205-232), on the
    host: for each class present in both datasets, shuffle its trials with
    ``rng`` and keep the shared minimum count. Returns (idx_a, idx_b),
    classes concatenated in sorted order. The same rng calls as the JAX
    package, so a seed gives the same indices."""
    ids_a = np.asarray(ids_a)
    ids_b = np.asarray(ids_b)
    shared = np.intersect1d(ids_a, ids_b)
    if shared.size == 0:
        raise ValueError(
            "no shared classes between the two datasets — trial-matched "
            "CCA needs at least one label present on both sides (check "
            "that both use the same label vocabulary, e.g. phoneme vs "
            "articulator ids)"
        )
    sel_a, sel_b = [], []
    for c in shared:
        cur_a = rng.permutation(np.where(ids_a == c)[0])
        cur_b = rng.permutation(np.where(ids_b == c)[0])
        m = min(len(cur_a), len(cur_b))
        sel_a.append(cur_a[:m])
        sel_b.append(cur_b[:m])
    return np.concatenate(sel_a), np.concatenate(sel_b)


def fit_cca_aligner_trial(X_a, X_b, idx_a, idx_b,
                          method: str = "gram") -> FittedAligner:
    """AlignCCA type='trial': CCA on matched trials (N, T, K) picked by
    :func:`shared_trial_subselect_indices`; time folds into rows."""
    same_device(X_a, X_b)
    ia = torch.as_tensor(np.asarray(idx_a), dtype=torch.long, device=X_a.device)
    ib = torch.as_tensor(np.asarray(idx_b), dtype=torch.long, device=X_b.device)
    La = X_a[ia].reshape(-1, X_a.shape[-1])
    Lb = X_b[ib].reshape(-1, X_b.shape[-1])
    alignment = cca_align(La, Lb, method=method)
    return FittedAligner(
        alignment=alignment,
        shared_mask=torch.ones(1, dtype=X_a.dtype, device=X_a.device),
    )
