"""PCA and no-center PCA with static-width masked components.

Port of ``cross_patient_speech_decoding_tpu/ops/pca.py``: the same
states, names and layouts. A fit returns components at a fixed width with
the inactive columns zeroed, an ``n_active`` count and a column mask;
zero columns stand for truncation in every consumer (matmuls, CCA with
masked ranks). ``sample_mask`` fits on a subset of rows of a fixed array.
Everything runs on the device of ``X``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cross_patient_speech_decoding_tpu_torch.ops.jacobi import symmetric_eigh
from cross_patient_speech_decoding_tpu_torch.ops.precision import hdot
from cross_patient_speech_decoding_tpu_torch.utils.device import same_device


class PCAState(NamedTuple):
    """Fitted PCA with static-width masked components.

    Attributes:
        mean: (F,) feature means (zeros for no-center PCA).
        components: (F, K) projection matrix; columns >= n_active are zero.
        explained_variance_ratio: (K,) per-component variance fractions
            (over ALL singular values, as sklearn).
        singular_values: (K,) singular values of the (centered) data.
        n_active: 0-d int32, number of active components.
        mask: (K,) float mask, 1.0 for active columns.
    """

    mean: torch.Tensor
    components: torch.Tensor
    explained_variance_ratio: torch.Tensor
    singular_values: torch.Tensor
    n_active: torch.Tensor
    mask: torch.Tensor


def _resolve_n_active(evr, s, n_components, max_k: int):
    """Number of active components from an int, a variance fraction (a
    Python float in (0, 1) or a floating tensor), a whole-count float, or
    None (the rank). ``evr`` and ``s`` are the full (..., min(N, F))
    arrays; a tensor ``n_components`` of shape (...) gives one count per
    row, broadcast against their leading dims (the nested search's
    per-candidate ``n_comp``)."""

    def _fraction(frac):
        csum = torch.cumsum(evr, dim=-1)
        frac = torch.as_tensor(frac, dtype=csum.dtype, device=csum.device)
        lead = torch.broadcast_shapes(csum.shape[:-1], frac.shape)
        csum = csum.expand(lead + csum.shape[-1:]).contiguous()
        # sklearn: searchsorted(cumsum, frac, side='right') + 1, per row
        n = torch.searchsorted(csum, frac.expand(lead)[..., None].contiguous(),
                               right=True)[..., 0] + 1
        return n.clamp(max=max_k).to(torch.int32)

    if isinstance(n_components, float):
        if 0.0 < n_components < 1.0:
            return _fraction(n_components)
        if n_components > 1.0 and n_components.is_integer():
            # PCA(30)-style counts delivered as 30.0 by float config fields;
            # 1.0 stays an error, as in sklearn
            n_components = int(n_components)
        else:
            raise ValueError(
                "float n_components must be in (0, 1) or a whole count > 1"
            )
    if n_components is None:
        n = (s > 0).sum(-1).to(torch.int32)  # rank
        return n.clamp(max=max_k)
    if isinstance(n_components, torch.Tensor) and n_components.is_floating_point():
        return _fraction(n_components)
    n = torch.as_tensor(n_components, dtype=torch.int32, device=s.device)
    return n.expand(torch.broadcast_shapes(n.shape, s.shape[:-1])).clamp(
        max=max_k)


def pca_fit(
    X: torch.Tensor,
    n_components=None,
    *,
    max_components: int | None = None,
    center: bool = True,
    sample_mask: torch.Tensor | None = None,
    method: str = "svd",
    low_refit_k: int = 0,
    low_thresh: int = 5,
) -> PCAState:
    """Fit (masked) PCA on X of shape (..., N, F).

    Args:
        X: (..., N, F) data; leading dims are a batch of fits. Rows where
            ``sample_mask == 0`` are ignored exactly.
        n_components: int, float in (0,1) (variance fraction), None (rank),
            or a tensor of per-row counts or fractions broadcast against
            the batch.
        max_components: static output width K; defaults to min(N, F).
        center: subtract the (masked) mean. False reproduces NoCenterPCA.
        sample_mask: optional (..., N) {0,1} validity mask, broadcast
            against X's leading dims (an unbatched X with a (B, N) mask
            fits B problems).
        method: 'svd' (default) or 'gram' (eigh of the (F, F) Gram).
        low_refit_k: if > 0 and the selection yields <= ``low_thresh``
            components, use ``low_refit_k`` components instead (the
            reference CTC datamodules' artifact guard).
        low_thresh: component-count threshold for ``low_refit_k``.

    The state's fields carry the batch's leading dims; ``mean`` keeps
    X's and the mask's, the component fields also those of a per-row
    ``n_components``.
    """
    same_device(X, sample_mask)
    N, F = X.shape[-2:]
    full_k = min(N, F)
    K = full_k if max_components is None else min(max_components, full_k)

    if sample_mask is None:
        mean = X.mean(-2) if center else torch.zeros(
            X.shape[:-2] + (F,), dtype=X.dtype, device=X.device)
        Xc = X - mean[..., None, :]
    else:
        w = sample_mask.to(X.dtype)
        n_valid = w.sum(-1).clamp(min=1.0)
        lead = torch.broadcast_shapes(X.shape[:-2], w.shape[:-1])
        mean = ((X * w[..., None]).sum(-2) / n_valid[..., None] if center
                else torch.zeros(lead + (F,), dtype=X.dtype, device=X.device))
        # invalid rows become exactly zero: nothing of them in X^T X
        Xc = (X - mean[..., None, :]) * w[..., None]

    if method == "gram":
        wv, v = symmetric_eigh(hdot(Xc.mT, Xc))
        s = torch.sqrt(wv.flip(-1).clamp(min=0.0))[..., :full_k]
        vt = v.flip(-1).mT[..., :full_k, :]
    else:
        _, s, vt = torch.linalg.svd(Xc, full_matrices=False)

    var = s**2
    total = var.sum(-1, keepdim=True).clamp(min=torch.finfo(X.dtype).tiny)
    evr_full = var / total

    n_active = _resolve_n_active(evr_full, s, n_components, K)
    if low_refit_k > 0:
        n_active = torch.where(
            n_active <= low_thresh,
            torch.clamp(torch.as_tensor(low_refit_k, dtype=torch.int32,
                                        device=X.device), max=K),
            n_active,
        )
    mask = (torch.arange(K, device=X.device) < n_active[..., None]).to(
        X.dtype)

    components = vt[..., :K, :].mT * mask[..., None, :]
    lead = components.shape[:-2]
    return PCAState(
        mean=mean,
        components=components,
        explained_variance_ratio=evr_full[..., :K].expand(lead + (K,)),
        singular_values=s[..., :K].expand(lead + (K,)),
        n_active=n_active,
        mask=mask,
    )


def _mean_rows(state: PCAState) -> torch.Tensor:
    """The mean to subtract from rows (..., N, F): a batched state's (B, F)
    mean as (B, 1, F)."""
    m = state.mean
    return m if m.dim() == 1 else m[..., None, :]


def pca_transform(state: PCAState, X: torch.Tensor) -> torch.Tensor:
    """Project X onto the fitted components: X (..., F) -> (..., K) for an
    unbatched state; X (..., N, F) -> (..., N, K) for a state with
    leading dims, which broadcast against X's."""
    return hdot(X - _mean_rows(state), state.components)


def pca_inverse_transform(state: PCAState, Z: torch.Tensor) -> torch.Tensor:
    """Map latents (..., K) back to feature space (..., F), as sklearn's
    ``PCA.inverse_transform``; masked latent columns are zero."""
    mask = state.mask if state.mask.dim() == 1 else state.mask[..., None, :]
    return hdot(Z * mask, state.components.mT) + _mean_rows(state)


def pca_fit_transform(X, n_components=None, **kwargs):
    state = pca_fit(X, n_components, **kwargs)
    return state, pca_transform(state, X)


def nocenter_pca_fit(X, n_components=None, **kwargs) -> PCAState:
    """NoCenterPCA (reference decomposition/NoCenterPCA.py): no centering."""
    return pca_fit(X, n_components, center=False, **kwargs)


def n_components_for_variance(X: torch.Tensor, var: float) -> torch.Tensor:
    """Reference ``AlignMCCA.n_components_var`` (AlignMCCA.py:156-174).

    Keeps the reference's ``argmax(cumsum > var)`` on purpose: it returns
    the *index* of the first component past the variance fraction, not the
    count. That is the documented contract.
    """
    s = torch.linalg.svdvals(X) ** 2
    s = s / s.sum()
    return torch.argmax((torch.cumsum(s, 0) > var).to(torch.int32)).to(
        torch.int32)
