"""Joint-PCA ("LFADS stitching") alignment.

Port of ``cross_patient_speech_decoding_tpu/ops/joint_pca.py`` (reference
``JointPCA``, JointPCA.py:165-211, after Pandarinath et al. 2018): PCA on
the channel-concatenated condition averages of all patients, then
per-patient read-ins ``pinv(cnd_avg_pt) @ latent``. Classes absent from
any patient are masked rows; pinv of a zero-row-masked matrix has zero
columns there, so the masked solution equals the row-selected one.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from cross_patient_speech_decoding_tpu_torch.ops.cca import cnd_avg
from cross_patient_speech_decoding_tpu_torch.ops.pca import (
    pca_fit,
    pca_transform,
)
from cross_patient_speech_decoding_tpu_torch.ops.precision import hdot, hpinv


class JointPCAState(NamedTuple):
    """Fitted joint-PCA stitching.

    Attributes:
        read_ins: tuple of (C_p, K) per-patient read-in matrices.
        shared_mask: (n_classes,) classes present in every patient.
        n_active: 0-d int32 active latent dims (masked columns are zero).
    """

    read_ins: tuple
    shared_mask: torch.Tensor
    n_active: torch.Tensor


def joint_pca_fit(
    Xs: Sequence[torch.Tensor],
    ids: Sequence[torch.Tensor],
    n_classes: int,
    n_components,
    *,
    max_components: int | None = None,
    sample_masks: Sequence[torch.Tensor] | None = None,
) -> JointPCAState:
    """Fit the shared latent space and per-patient read-ins.

    Args:
        Xs: per-patient (N_p, T, C_p) trial tensors.
        ids: per-patient (N_p,) compact class ids.
        n_classes: class-universe size.
        n_components: int or variance fraction for the shared PCA.
        max_components: latent width (defaults to what PCA allows).
        sample_masks: optional per-patient trial validity masks.
    """
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
    row_mask = torch.repeat_interleave(shared_f, T)  # (n_classes * T,)

    # channel-concatenated condition averages, class x time as rows
    flats = [a.reshape(n_classes * T, a.shape[-1]) * row_mask[:, None]
             for a in avgs]
    cross_mat = torch.cat(flats, dim=-1)

    pca = pca_fit(cross_mat, n_components, max_components=max_components,
                  sample_mask=row_mask)
    latent = pca_transform(pca, cross_mat) * row_mask[:, None]

    read_ins = tuple(hdot(hpinv(f), latent) for f in flats)
    return JointPCAState(read_ins=read_ins, shared_mask=shared_f,
                         n_active=pca.n_active)


def joint_pca_transform(state: JointPCAState, X: torch.Tensor, idx: int):
    """Project patient ``idx`` data (..., C_p) into the shared space."""
    return hdot(X, state.read_ins[idx])
