"""Batched closed-form kernel ridge classifiers of the classical decoders.

Port of ``cross_patient_speech_decoding_tpu/ops/classifiers.py``. The
reference decodes with ``SVC(kernel='rbf', class_weight='balanced')`` or a
bagged linear SVC; the JAX package replaces libsvm's sequential solver by a
weighted kernel ridge (LS-SVM) one-vs-rest classifier: the closed-form
solve of ``(W K + lam I) A = W Y`` with balanced sample weights W, all
products and one Cholesky. The port keeps that math and its names.

Where JAX vmaps a fit over folds, candidates or bootstrap draws, the port
carries them as leading batch dims: ``X`` (..., N, F), masks (..., N),
feature masks (..., F), and ``gamma``/``lam`` scalars or (...) tensors.
Every product runs in full float32 (``ops/precision.py``).

Masking contract: rows with ``sample_mask == 0`` get zero weight, so their
dual rows are exactly 0, and one fixed (N, N) system solves any fold.

The bootstrap of :func:`bagged_classifier_fit` is split in two:
:func:`bootstrap_counts_draw` takes its random numbers from a
``torch.Generator``, and :func:`bagged_classifier_fit_counts` fits the
ensemble from the multiplicity counts, so that a test can feed it the JAX
package's own draws. The streams differ from ``jax.random`` by design.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cross_patient_speech_decoding_tpu_torch.ops.precision import (
    hdot,
    true_f32,
)


class KernelClassifier(NamedTuple):
    """Fitted kernel ridge one-vs-rest classifier (leading dims batch it).

    The kernel's name is not stored: callers pass ``kernel=`` to
    :func:`kernel_classifier_decision` and :func:`kernel_classifier_predict`,
    as in the JAX package.

    Attributes:
        X_train: (..., N, F) training features.
        dual_coef: (..., N, C) dual coefficients (zero rows for masked
            samples).
        gamma: (...) RBF bandwidth (0 for the linear kernel).
    """

    X_train: torch.Tensor
    dual_coef: torch.Tensor
    gamma: torch.Tensor


def _sq_dists(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Pairwise squared Euclidean distances (..., M, N) via one product."""
    a2 = (A**2).sum(-1)[..., :, None]
    b2 = (B**2).sum(-1)[..., None, :]
    return (a2 + b2 - 2.0 * hdot(A, B.mT)).clamp(min=0.0)


def rbf_kernel(A: torch.Tensor, B: torch.Tensor, gamma) -> torch.Tensor:
    """exp(-gamma |a - b|^2); ``gamma`` a scalar or a (...) tensor."""
    g = torch.as_tensor(gamma, dtype=A.dtype, device=A.device)
    return torch.exp(-g[..., None, None] * _sq_dists(A, B))


def scale_gamma(X: torch.Tensor, sample_mask=None,
                feature_mask=None) -> torch.Tensor:
    """sklearn SVC gamma='scale' = 1 / (n_features * X.var()), mask-aware.

    Counts and the variance run over the active samples and features only,
    so a zero-padded feature block gets the bandwidth of its truncated
    width. X (..., N, F), sample_mask (..., N), feature_mask (..., F);
    returns (...).
    """
    dtype = X.dtype
    w = (torch.ones(X.shape[:-1], dtype=dtype, device=X.device)
         if sample_mask is None else sample_mask.to(dtype))
    f = (torch.ones(X.shape[-1], dtype=dtype, device=X.device)
         if feature_mask is None else feature_mask.to(dtype))
    n = w.sum(-1).clamp(min=1.0)
    nf = f.sum(-1).clamp(min=1.0)
    mean = (X * w[..., None]).sum(-2) / n[..., None]
    var_per_feat = (((X - mean[..., None, :]) ** 2) * w[..., None]).sum(-2) \
        / n[..., None]
    # sklearn's variance is over the flattened active block
    mean_all = (mean * f).sum(-1) / nf
    var = ((var_per_feat + mean**2) * f).sum(-1) / nf - mean_all**2
    return 1.0 / (nf * var.clamp(min=torch.finfo(dtype).tiny))


def balanced_sample_weights(y: torch.Tensor, n_classes: int,
                            sample_mask=None) -> torch.Tensor:
    """class_weight='balanced': w_i = n_valid / (n_present * count[y_i]).

    y (..., N) or (N,) integer ids, sample_mask (..., N); the per-class
    counts are a scatter-add along the last axis (exact for integer
    weights)."""
    w = (torch.ones(y.shape, dtype=torch.float32, device=y.device)
         if sample_mask is None else sample_mask.to(torch.float32))
    shape = torch.broadcast_shapes(y.shape, w.shape)
    y_b, w = y.long().expand(shape), w.expand(shape)
    counts = torch.zeros(w.shape[:-1] + (n_classes,), dtype=w.dtype,
                         device=w.device).scatter_add_(-1, y_b, w)
    present = (counts > 0).to(counts.dtype).sum(-1)
    n_valid = w.sum(-1)
    per_class = n_valid[..., None] / (present[..., None]
                                      * counts.clamp(min=1.0))
    return per_class.gather(-1, y_b) * w


def _one_hot_pm(y: torch.Tensor, n_classes: int, dtype) -> torch.Tensor:
    """+1 / -1 one-vs-rest coding (..., N, C)."""
    oh = torch.nn.functional.one_hot(y.long(), n_classes).to(dtype)
    return 2.0 * oh - 1.0


def kernel_classifier_fit(
    X: torch.Tensor,
    y: torch.Tensor,
    n_classes: int,
    *,
    gamma=None,
    lam=1.0,
    sample_mask=None,
    feature_mask=None,
    balanced: bool = True,
    kernel: str = "rbf",
) -> KernelClassifier:
    """Fit a weighted kernel ridge one-vs-rest classifier.

    Solves ``(W K + lam I) D = W Y`` (W the balanced sample weights times
    the validity mask, Y the +1/-1 coding) in the symmetric form: with
    V = W^1/2, D = V S where ``(V K V + lam I) S = V Y``, one Cholesky and
    two triangular solves of an SPD system (never LU). Masked rows get
    exactly zero dual rows. A factorisation that fails (a system that is
    not positive definite) gives NaN coefficients and so non-finite
    scores, as ``jnp.linalg.cholesky`` does, not an exception.

    Leading dims of X, y, the masks, ``gamma`` and ``lam`` broadcast to
    the batch of fits.
    """
    N = X.shape[-2]
    dtype, dev = X.dtype, X.device
    if gamma is None and kernel == "rbf":
        gamma = scale_gamma(X, sample_mask, feature_mask)
    gamma = torch.as_tensor(0.0 if kernel == "linear" else gamma,
                            dtype=dtype, device=dev)

    K = hdot(X, X.mT) if kernel == "linear" else rbf_kernel(X, X, gamma)

    if balanced:
        w = balanced_sample_weights(y, n_classes, sample_mask).to(dtype)
    else:
        w = (torch.ones(N, dtype=dtype, device=dev) if sample_mask is None
             else sample_mask.to(dtype))

    Y = _one_hot_pm(y, n_classes, dtype)
    lam = torch.as_tensor(lam, dtype=dtype, device=dev)
    ws = torch.sqrt(w)
    M = ws[..., :, None] * K * ws[..., None, :] \
        + lam[..., None, None] * torch.eye(N, dtype=dtype, device=dev)
    rhs = ws[..., None] * Y
    with true_f32():
        L, info = torch.linalg.cholesky_ex(M)
        L = torch.where((info == 0)[..., None, None], L, torch.nan)
        z = torch.linalg.solve_triangular(L, rhs, upper=False)
        S = torch.linalg.solve_triangular(L.mT, z, upper=True)
    dual = ws[..., None] * S
    return KernelClassifier(X_train=X, dual_coef=dual,
                            gamma=gamma.expand(dual.shape[:-2]))


def kernel_classifier_decision(clf: KernelClassifier, X: torch.Tensor,
                               kernel: str) -> torch.Tensor:
    """(..., M, C) one-vs-rest scores of the rows of X (..., M, F)."""
    k = (hdot(X, clf.X_train.mT) if kernel == "linear"
         else rbf_kernel(X, clf.X_train, clf.gamma))
    return hdot(k, clf.dual_coef)


def kernel_classifier_predict(clf: KernelClassifier, X: torch.Tensor,
                              kernel: str) -> torch.Tensor:
    """Argmax class (..., M) as int64; ties and NaN rows resolve as
    ``jnp.argmax`` does (the first maximum, NaN counting as one)."""
    return torch.argmax(kernel_classifier_decision(clf, X, kernel), dim=-1)


def bootstrap_counts_draw(generator: torch.Generator, sample_mask,
                          n_estimators: int) -> torch.Tensor:
    """Bootstrap multiplicities ~ Multinomial(N, p), p = mask / sum(mask).

    One (E, N) block of float64 uniforms is drawn from ``generator`` and
    shared by every row of a batched ``sample_mask`` (..., N), as the JAX
    package draws every fold of a vmap from one key; each row maps them
    through its own float64 CDF. Returns (..., E, N) counts in the mask's
    dtype, on the mask's device.
    """
    N = sample_mask.shape[-1]
    u = torch.rand((n_estimators, N), generator=generator,
                   dtype=torch.float64, device=generator.device)
    u = u.to(sample_mask.device)
    p = sample_mask.to(torch.float64)
    cdf = torch.cumsum(p / p.sum(-1, keepdim=True).clamp(min=1.0), dim=-1)
    lead = cdf.shape[:-1]
    cdf_e = cdf[..., None, :].expand(lead + (n_estimators, N)).contiguous()
    v = u.expand(lead + (n_estimators, N)) * cdf_e[..., -1:]
    idx = torch.searchsorted(cdf_e, v.contiguous(), right=True).clamp(
        max=N - 1)
    counts = torch.zeros(lead + (n_estimators, N), dtype=sample_mask.dtype,
                         device=sample_mask.device)
    return counts.scatter_add_(-1, idx, torch.ones_like(counts))


def bagged_classifier_fit_counts(
    X: torch.Tensor,
    y: torch.Tensor,
    n_classes: int,
    counts: torch.Tensor,
    *,
    kernel: str = "linear",
    lam=1.0,
    gamma=None,
    feature_mask=None,
    balanced: bool = False,
) -> KernelClassifier:
    """The ensemble from bootstrap multiplicities: every estimator is a
    weighted fit with its counts (..., E, N) as sample weights, all as one
    batch. X (..., N, F); ``gamma``/``lam`` (...) apply to every estimator
    of their row. Returns a classifier with lead dims (..., E)."""
    if gamma is not None:
        gamma = torch.as_tensor(gamma, dtype=X.dtype,
                                device=X.device)[..., None]
    if torch.is_tensor(lam):
        lam = lam[..., None]
    fm = None if feature_mask is None else feature_mask[..., None, :]
    return kernel_classifier_fit(
        X[..., None, :, :], y, n_classes, lam=lam, gamma=gamma,
        sample_mask=counts, feature_mask=fm, kernel=kernel,
        balanced=balanced)


def bagged_classifier_fit(
    generator: torch.Generator,
    X: torch.Tensor,
    y: torch.Tensor,
    n_classes: int,
    n_estimators: int = 10,
    *,
    kernel: str = "linear",
    lam=1.0,
    gamma=None,
    sample_mask=None,
    feature_mask=None,
    balanced: bool = False,
) -> KernelClassifier:
    """Bootstrap-aggregated classifier, the reference's
    ``BaggingClassifier(SVC(kernel='linear'), n_estimators=10)``: a draw
    (:func:`bootstrap_counts_draw`) and the batched fits of its
    multiplicities (:func:`bagged_classifier_fit_counts`). ``balanced``
    defaults to False, as the reference's bagged SVC carries no
    ``class_weight``."""
    if sample_mask is None:
        sample_mask = torch.ones(X.shape[:-1], dtype=X.dtype,
                                 device=X.device)
    counts = bootstrap_counts_draw(generator, sample_mask, n_estimators)
    return bagged_classifier_fit_counts(
        X, y, n_classes, counts, kernel=kernel, lam=lam, gamma=gamma,
        feature_mask=feature_mask, balanced=balanced)


def bagged_classifier_predict(clf: KernelClassifier, X: torch.Tensor,
                              kernel: str) -> torch.Tensor:
    """Majority vote over the ensemble (the estimators are the last lead
    dim of ``clf``): argmax of the summed decision scores. X (..., M, F)."""
    scores = kernel_classifier_decision(clf, X[..., None, :, :], kernel)
    return torch.argmax(scores.sum(-3), dim=-1)
