"""Regularised multiview CCA (MCCA) as one generalised eigensolve.

Port of ``cross_patient_speech_decoding_tpu/ops/mcca.py``, the MAXVAR form
of ``mvlearn.embed.MCCA`` (AlignMCCA.py:140-154):

    C w = lambda D_r w,   D_r = (1 - r) D + r I

with C the Gram of the concatenated centered views and D its block
diagonal (raw X^T X, unscaled r I, as mvlearn). ``signal_ranks`` keep the
top eigendirections of each view's whitener. Solved by block-wise
inverse-sqrt whitening and one symmetric eigh, on the device of the views.
These eighs go to ``torch.linalg.eigh`` (symmetrised), as the JAX module
calls ``jnp.linalg.eigh``: they are not on the Jacobi kernel's route.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from cross_patient_speech_decoding_tpu_torch.ops.cca import cnd_avg
from cross_patient_speech_decoding_tpu_torch.ops.jacobi import symmetric_eigh
from cross_patient_speech_decoding_tpu_torch.ops.pca import (
    n_components_for_variance,
)
from cross_patient_speech_decoding_tpu_torch.ops.precision import hdot
from cross_patient_speech_decoding_tpu_torch.utils.device import same_device


class MCCAState(NamedTuple):
    """Fitted MCCA.

    Attributes:
        loadings: tuple of (p_i, n_components) per-view projection matrices.
        means: tuple of (p_i,) per-view feature means.
        evals: (n_components,) generalised eigenvalues.
        shared_mask: (n_classes,) classes present in all views (class mode).
    """

    loadings: tuple
    means: tuple
    evals: torch.Tensor
    shared_mask: torch.Tensor | None


def _inv_sqrt_psd(A, rank_mask, reg_floor: float):
    """Inverse square root of a PSD matrix, null directions (and, with
    ``rank_mask``, all but the top ``rank_mask``) masked."""
    w, v = symmetric_eigh(A)
    n = A.shape[0]
    tol = w.max().clamp(min=0.0) * n * torch.finfo(A.dtype).eps
    keep = w > tol.clamp(min=reg_floor)
    if rank_mask is not None:
        # eigh is ascending: column i has rank position n-1-i
        k_idx = torch.arange(n - 1, -1, -1, device=A.device)
        keep = keep & (k_idx < rank_mask)
    w_is = torch.where(keep, 1.0 / torch.sqrt(torch.where(keep, w, 1.0)), 0.0)
    return hdot(v * w_is[None, :], v.T)


def mcca_fit(
    Xs: Sequence[torch.Tensor],
    n_components: int,
    regs: float = 0.5,
    signal_ranks: Sequence | None = None,
    row_mask: torch.Tensor | None = None,
) -> MCCAState:
    """Fit regularised MCCA on 2-D views (rows = samples).

    Args:
        Xs: per-view (R, p_i) matrices sharing the row layout/mask.
        n_components: number of canonical components.
        regs: regularisation in [0, 1].
        signal_ranks: optional per-view rank limits (ints or 0-d tensors).
        row_mask: optional (R,) validity mask.
    """
    same_device(*Xs, row_mask)
    P = len(Xs)
    dtype, device = Xs[0].dtype, Xs[0].device
    R = Xs[0].shape[0]
    w = (torch.ones(R, dtype=dtype, device=device) if row_mask is None
         else row_mask.to(dtype))
    n = w.sum().clamp(min=1.0)

    centered, means = [], []
    for X in Xs:
        mean = (X * w[:, None]).sum(0) / n
        centered.append((X - mean) * w[:, None])
        means.append(mean)

    # whiteners of the regularised within-view Grams (mvlearn convention:
    # raw X^T X, identity not scaled by the sample count)
    whiteners = []
    for i, Xc in enumerate(centered):
        gram = hdot(Xc.T, Xc)
        p = gram.shape[0]
        gram_r = (1.0 - regs) * gram + regs * torch.eye(p, dtype=dtype,
                                                         device=device)
        rmask = None if signal_ranks is None else signal_ranks[i]
        whiteners.append(_inv_sqrt_psd(gram_r, rmask, reg_floor=0.0))

    # whitened concatenated Gram E_ij = W_i^T (X_i^T X_j) W_j
    E = torch.cat([
        torch.cat([
            hdot(whiteners[i], hdot(hdot(centered[i].T, centered[j]),
                                    whiteners[j]))
            for j in range(P)
        ], dim=1)
        for i in range(P)
    ], dim=0)
    E = 0.5 * (E + E.T)

    evals, evecs = symmetric_eigh(E)
    top = evecs.flip(-1)[:, :n_components]
    evals_top = evals.flip(-1)[:n_components]

    loadings, off = [], 0
    for i, X in enumerate(Xs):
        p = X.shape[1]
        loadings.append(hdot(whiteners[i], top[off:off + p, :]))
        off += p
    return MCCAState(
        loadings=tuple(loadings),
        means=tuple(means),
        evals=evals_top,
        shared_mask=None,
    )


def mcca_transform(state: MCCAState, X: torch.Tensor, idx: int):
    """Project view ``idx`` data (..., p_i) into the shared space."""
    return hdot(X - state.means[idx], state.loadings[idx])


def fit_mcca_aligner(
    Xs: Sequence[torch.Tensor],
    ids: Sequence[torch.Tensor],
    n_classes: int,
    n_components: int,
    regs: float = 0.5,
    pca_var: float = 1.0,
    sample_masks: Sequence | None = None,
) -> MCCAState:
    """AlignMCCA-equivalent: condition-average the (N, T, p_i) views over
    the classes shared by all, fit MCCA. When ``0 < pca_var < 1`` the
    per-view signal ranks come from the reference's ``argmax(cumsum >
    var)`` rule on the (masked) trial data, capped at ``n_components``
    (AlignMCCA.py:148-150)."""
    P = len(Xs)
    masks = sample_masks if sample_masks is not None else [None] * P

    avgs, shared = [], None
    for X, y, m in zip(Xs, ids, masks):
        avg, cnt = cnd_avg(X, y, n_classes, m)
        avgs.append(avg)
        pres = cnt > 0
        shared = pres if shared is None else (shared & pres)
    shared_f = shared.to(Xs[0].dtype)
    T = Xs[0].shape[1]
    row_mask = torch.repeat_interleave(shared_f, T)
    flats = [a.reshape(n_classes * T, a.shape[-1]) for a in avgs]

    ranks = None
    if 0.0 < pca_var < 1.0:
        # masked (held-out) trials are zero rows: no part of the spectrum
        ranks = [
            n_components_for_variance(
                (X if m is None else X * m[:, None, None]).reshape(
                    -1, X.shape[-1]),
                pca_var,
            ).clamp(max=n_components)
            for X, m in zip(Xs, masks)
        ]

    state = mcca_fit(flats, n_components, regs, ranks, row_mask)
    return state._replace(shared_mask=shared_f)
