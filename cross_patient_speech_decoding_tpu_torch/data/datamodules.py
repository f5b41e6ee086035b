"""Fold preparation: the reference's datamodules as functions.

Port of ``cross_patient_speech_decoding_tpu/data/datamodules.py``. The
reference wraps fold preparation in Lightning DataModules with HDF5 fold
caches; here each is a function that returns the folds' arrays:

- :func:`simple_folds`: one patient, stratified k-fold, a validation split
  of each fold's training rows, optional augmentation appended to train
  (SimpleMicroDataModule);
- :func:`aligned_folds`: per fold, the target's PCA (a variance fraction)
  fitted on the fold's training rows, each source's CCA alignment into the
  target's latent space, the sources pooled into train; validation and
  test rows through the target's PCA (AlignedMicroDataModule,
  ``process_aligner``). ``align_before_split=True`` fits the target's PCA
  and the CCAs once, on all rows (AlignedMicroValDataModule);
- :func:`ctc_holdout`: a train / validation / test split of the target,
  the other datasets pooled whole into train (the CTCHeldOutDataModule
  family).

The splits are the port's own copy of the JAX package's (``data/splits``),
drawn from the same ``np.random.Generator`` sequence, so a seed gives the
same rows in both packages. The PCA and CCA fits of :func:`aligned_folds`
run on the device of the patients' tensors; every function returns host
numpy arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cross_patient_speech_decoding_tpu_torch.data.splits import (
    stratified_kfold_masks,
    train_val_test_masks,
)
from cross_patient_speech_decoding_tpu_torch.decoders.pooled import (
    PatientArrays,
    _fit_pca_latents,
    _transform_latents,
)
from cross_patient_speech_decoding_tpu_torch.ops.cca import (
    fit_cca_aligner,
    transform_b_to_a,
)
from cross_patient_speech_decoding_tpu_torch.utils.device import (
    resolve_device,
)


class FoldData(NamedTuple):
    """One fold's arrays: (X, y) train / val / test."""

    train: tuple
    val: tuple
    test: tuple


def _split_val(idx: np.ndarray, val_frac: float, rng):
    idx = rng.permutation(idx)
    n_val = int(round(len(idx) * val_frac))
    return idx[n_val:], idx[:n_val]


def simple_folds(X: np.ndarray, y: np.ndarray, n_folds: int = 20,
                 val_frac: float = 0.1, seed: int = 0, augment=None,
                 device=None):
    """Single-patient stratified k-fold with a validation split.

    ``augment``: optional callable (generator, X_train, y_train) ->
    (X_aug, y_aug), appended to train (the reference's augmentation
    concat). It gets fold k's training rows as tensors on ``device``
    (default: the first CUDA card, raises without one; read only when
    ``augment`` is given) and a generator there seeded ``seed * 1000 + k``,
    where the JAX package passes ``jax.random.key(seed * 1000 + k)``.
    """
    rng = np.random.default_rng(seed)
    tr_m, te_m = stratified_kfold_masks(y, n_folds, rng)
    dev = resolve_device(device) if augment is not None else None
    folds = []
    for k in range(n_folds):
        tr_idx = np.where(tr_m[k] > 0)[0]
        te_idx = np.where(te_m[k] > 0)[0]
        tr_idx, va_idx = _split_val(tr_idx, val_frac, rng)
        X_tr, y_tr = X[tr_idx], y[tr_idx]
        if augment is not None:
            gen = torch.Generator(device=dev).manual_seed(seed * 1000 + k)
            X_aug, y_aug = augment(gen, torch.as_tensor(X_tr, device=dev),
                                   torch.as_tensor(y_tr, device=dev))
            X_tr = np.concatenate([X_tr, _host(X_aug)])
            y_tr = np.concatenate([y_tr, _host(y_aug)])
        folds.append(FoldData(train=(X_tr, y_tr), val=(X[va_idx], y[va_idx]),
                              test=(X[te_idx], y[te_idx])))
    return folds


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def aligned_folds(tar: PatientArrays, cross, n_align_classes: int,
                  n_folds: int = 20, n_comp: float = 0.95, max_k: int = 32,
                  val_frac: float = 0.1, seed: int = 0,
                  align_before_split: bool = False):
    """Cross-patient aligned fold preparation (``process_aligner``).

    Per fold: the target's PCA fitted on the fold's training rows (on all
    rows when ``align_before_split``), each source's class-averaged chol
    CCA into the target's latent space, the sources' aligned rows pooled
    into train. The sources' PCAs do not depend on the split and are
    fitted once. ``tar`` and the ``cross`` patients are
    :class:`~cross_patient_speech_decoding_tpu_torch.decoders.pooled.
    PatientArrays` on one device, where the fits run.

    Returns a list of :class:`FoldData` with flattened (N, T*K) features.
    """
    rng = np.random.default_rng(seed)
    y_host = _host(tar.y)
    tr_m, te_m = stratified_kfold_masks(y_host, n_folds, rng)

    src_lats = []
    for src in cross:
        src_pca = _fit_pca_latents(src.X, n_comp, max_k)
        src_lats.append(_transform_latents(src_pca, src.X, max_k))

    def _align(fit_mask):
        tar_pca = _fit_pca_latents(tar.X, n_comp, max_k, fit_mask)
        tar_lat = _transform_latents(tar_pca, tar.X, max_k)
        pooled_X, pooled_y = [], []
        for src, src_lat in zip(cross, src_lats):
            al = fit_cca_aligner(tar_lat, src_lat, tar.y_align, src.y_align,
                                 n_align_classes, mask_a=fit_mask)
            aligned = transform_b_to_a(al, src_lat)
            pooled_X.append(_host(aligned).reshape(len(src.y), -1))
            pooled_y.append(_host(src.y))
        return _host(tar_lat).reshape(len(y_host), -1), pooled_X, pooled_y

    shared = _align(None) if align_before_split else None
    folds = []
    for k in range(n_folds):
        tar_flat, pooled_X, pooled_y = (
            shared if shared is not None
            else _align(torch.as_tensor(tr_m[k], dtype=torch.float32,
                                        device=tar.X.device))
        )
        tr_idx = np.where(tr_m[k] > 0)[0]
        te_idx = np.where(te_m[k] > 0)[0]
        tr_idx, va_idx = _split_val(tr_idx, val_frac, rng)
        X_tr = np.concatenate([tar_flat[tr_idx]] + pooled_X)
        y_tr = np.concatenate([y_host[tr_idx]] + pooled_y)
        folds.append(FoldData(train=(X_tr, y_tr),
                              val=(tar_flat[va_idx], y_host[va_idx]),
                              test=(tar_flat[te_idx], y_host[te_idx])))
    return folds


def ctc_holdout(datasets, val_frac: float = 0.1, test_frac: float = 0.2,
                seed: int = 0):
    """CTC held-out split with the cross datasets pooled into train.

    ``datasets``: a list of (X, labels, input_lens, label_lens) numpy
    arrays; element 0 is the target, split into train / val / test, the
    rest join train whole (the CTCHeldOutTargetVal* contract).
    """
    rng = np.random.default_rng(seed)
    X, y, il, ll = datasets[0]
    tr, va, te = train_val_test_masks(len(X), rng, val_frac, test_frac)
    tr_i, va_i, te_i = (np.where(m > 0)[0] for m in (tr, va, te))

    def sel(idx):
        return (X[idx], y[idx], il[idx], ll[idx])

    train = sel(tr_i)
    if len(datasets) > 1:
        parts = list(zip(*([train] + list(datasets[1:]))))
        train = tuple(np.concatenate(p) for p in parts)
    return FoldData(train=train, val=sel(va_i), test=sel(te_i))
