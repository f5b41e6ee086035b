"""Per-patient PCA latents of the pooled decoders.

Port of ``_fit_pca_latents`` and ``_transform_latents``
(``cross_patient_speech_decoding_tpu/decoders/pooled.py:93-115``) and
their public names, which the CTC driver's pooled contexts use. The
rest of the module (pooling, classifiers) comes with the classical
decoders (ROADMAP queue 1, item 6).
"""

from __future__ import annotations

import torch

from cross_patient_speech_decoding_tpu_torch.ops.pca import (
    PCAState,
    pca_fit,
    pca_transform,
)


def _fit_pca_latents(X: torch.Tensor, n_comp, max_k: int,
                     sample_mask: torch.Tensor | None = None,
                     low_refit_k: int = 0) -> PCAState:
    """PCA over the flattened (N*T, C) rows of X (N, T, C), with an
    optional (N,) per-trial mask.

    Uses the Gram path: N*T >> C in every caller, so the (C, C)
    covariance eigensolve replaces a tall SVD. ``low_refit_k`` enables the
    CTC datamodules' low-component artifact guard (see
    :func:`~cross_patient_speech_decoding_tpu_torch.ops.pca.pca_fit`).
    """
    N, T, C = X.shape
    row_mask = None
    if sample_mask is not None:
        row_mask = torch.repeat_interleave(sample_mask, T)
    return pca_fit(X.reshape(N * T, C), n_comp, max_components=max_k,
                   sample_mask=row_mask, method="gram",
                   low_refit_k=low_refit_k)


def _transform_latents(st: PCAState, X: torch.Tensor,
                       max_k: int) -> torch.Tensor:
    """(N, T, C) trials -> (N, T, K) latents through the fitted PCA."""
    N, T, C = X.shape
    return pca_transform(st, X.reshape(N * T, C)).reshape(N, T, -1)


# public names, as in the JAX package
fit_pca_latents = _fit_pca_latents
transform_latents = _transform_latents
