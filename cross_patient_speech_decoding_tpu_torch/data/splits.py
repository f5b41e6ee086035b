"""Cross-validation split generation as mask batches.

Port of ``cross_patient_speech_decoding_tpu/data/splits.py`` (numpy only,
kept here as the port's own copy, with the same draws from the same
``np.random.Generator``). The reference runs sklearn
``StratifiedKFold(n_splits, shuffle=True)`` (with a ``KFold`` fallback
when some class has fewer members than folds); here splits are boolean
mask arrays of shape (n_iters * n_folds, N).
"""

from __future__ import annotations

import numpy as np


def stratified_kfold_masks(y: np.ndarray, n_folds: int, rng: np.random.Generator):
    """One shuffled stratified k-fold split -> (train_masks, test_masks).

    Falls back to plain KFold when any class has fewer members than
    ``n_folds`` (the reference's ``select_cv`` behavior).
    """
    y = np.asarray(y)
    N = len(y)
    test_fold = np.empty(N, dtype=np.int64)

    _, counts = np.unique(y, return_counts=True)
    if counts.min() < n_folds:
        perm = rng.permutation(N)
        for f, chunk in enumerate(np.array_split(perm, n_folds)):
            test_fold[chunk] = f
    else:
        for c in np.unique(y):
            idx = rng.permutation(np.where(y == c)[0])
            for f, chunk in enumerate(np.array_split(idx, n_folds)):
                test_fold[chunk] = f

    folds = np.arange(n_folds)[:, None]
    test_masks = (test_fold[None, :] == folds).astype(np.float64)
    train_masks = 1.0 - test_masks
    return train_masks, test_masks


def repeated_stratified_kfold_masks(
    y: np.ndarray, n_folds: int, n_iters: int, seed: int = 0
):
    """(n_iters * n_folds, N) masks for the reference's repeated-CV design."""
    rng = np.random.default_rng(seed)
    trs, tes = [], []
    for _ in range(n_iters):
        tr, te = stratified_kfold_masks(y, n_folds, rng)
        trs.append(tr)
        tes.append(te)
    return np.concatenate(trs), np.concatenate(tes)


def train_val_test_masks(
    N: int, rng: np.random.Generator, val_frac: float = 0.1, test_frac: float = 0.2
):
    """Single shuffled train/val/test split as three masks."""
    perm = rng.permutation(N)
    n_test = int(round(N * test_frac))
    n_val = int(round(N * val_frac))
    test = np.zeros(N)
    val = np.zeros(N)
    train = np.zeros(N)
    test[perm[:n_test]] = 1
    val[perm[n_test : n_test + n_val]] = 1
    train[perm[n_test + n_val :]] = 1
    return train, val, test


def stratified_train_subsample_masks(
    train_masks: np.ndarray,
    y: np.ndarray,
    frac: float,
    rng: np.random.Generator,
) -> np.ndarray:
    """Stratified subsample of each fold row's TRAIN set to ``frac`` of it.

    The reference subsamples the target train split per outer fold with
    ``train_test_split(train_size=frac, stratify=lab_tar_train)``
    (`aligned_decode_svm_ncv.py:351-360`, the ``-tss`` flag): keep
    ``floor(frac * n_train)`` rows, allocated proportionally per class
    (largest-remainder rounding, >= 1 per present class). Test masks are
    untouched; returns a new train-mask stack of the same shape.
    """
    if frac >= 1.0:
        return train_masks
    y = np.asarray(y)
    out = np.zeros_like(train_masks)
    for f in range(train_masks.shape[0]):
        tr_idx = np.where(train_masks[f] > 0)[0]
        labs = y[tr_idx]
        classes, counts = np.unique(labs, return_counts=True)
        n_keep = int(np.floor(frac * len(tr_idx)))
        raw = frac * counts
        base = np.floor(raw).astype(int)
        extra = np.argsort(-(raw - base))
        base[extra[: max(0, n_keep - base.sum())]] += 1
        base = np.maximum(base, 1)  # stratified split: every class survives
        kept = np.concatenate(
            [
                rng.permutation(tr_idx[labs == c])[:k]
                for c, k in zip(classes, base)
            ]
        )
        out[f, kept] = 1.0
    return out
