"""Decode-quality metrics: confusion-matrix accuracy, edit distance and
phoneme error rate over padded batches.

Port of ``cross_patient_speech_decoding_tpu/ops/metrics.py``.
``balanced_accuracy`` takes leading batch dims (one score a fold).
``cmat_acc_iter`` is numpy, as in the JAX package; ``pearson_r`` and the
alignment-quality correlations ``pt_corr``, ``pt_corr_multi`` and
``pt_corr_dims`` run on the caller's device, their p-values on the host in
float64 (torch has no incomplete beta function).
"""

from __future__ import annotations

import numpy as np
import torch


def confusion_matrix(y_true, y_pred, n_classes: int, sample_mask=None):
    """(n_classes, n_classes) float32 confusion counts, rows true, columns
    predicted; ``sample_mask`` weights each sample (default 1)."""
    idx = (y_true.long() * n_classes + y_pred.long()).reshape(-1)
    w = (torch.ones(idx.shape, dtype=torch.float32, device=idx.device)
         if sample_mask is None else sample_mask.float().reshape(-1))
    flat = torch.zeros(n_classes * n_classes, dtype=torch.float32,
                       device=idx.device).index_add_(0, idx, w)
    return flat.reshape(n_classes, n_classes)


def balanced_accuracy(y_true, y_pred, n_classes: int, sample_mask=None):
    """Mean per-class recall over the classes present in ``y_true``
    (sklearn's ``balanced_accuracy_score``), weighted by ``sample_mask``.

    y_true, y_pred and the mask may carry leading dims (they broadcast);
    returns one float32 score per leading index. The confusion counts are
    a scatter-add along the last axis, exact for integer weights.
    """
    shape = torch.broadcast_shapes(
        y_true.shape, y_pred.shape,
        () if sample_mask is None else sample_mask.shape)
    idx = (y_true.long() * n_classes + y_pred.long()).expand(shape)
    w = (torch.ones(shape, dtype=torch.float32, device=idx.device)
         if sample_mask is None else sample_mask.float().expand(shape))
    cm = torch.zeros(shape[:-1] + (n_classes * n_classes,),
                     dtype=torch.float32, device=idx.device)
    cm = cm.scatter_add_(-1, idx, w).reshape(
        shape[:-1] + (n_classes, n_classes))
    support = cm.sum(-1)
    recall = torch.diagonal(cm, dim1=-2, dim2=-1) / support.clamp(min=1.0)
    present = (support > 0).to(recall.dtype)
    return (recall * present).sum(-1) / present.sum(-1).clamp(min=1.0)


def cmat_acc(y_true, y_pred, n_classes: int, sample_mask=None):
    """trace(confusion) / sum(confusion), the reference's NN accuracy
    (nn_models/models.py:875-889); 0-d float32."""
    cm = confusion_matrix(y_true, y_pred, n_classes, sample_mask)
    return torch.trace(cm) / cm.sum().clamp(min=1.0)



def cmat_acc_iter(y_true_iter, y_pred_iter):
    """Confusion-matrix accuracy per (y_true, y_pred) pair, the figure
    notebooks' ``cmat_wrap`` helper (fig_3.ipynb and 15 others). Numpy:
    its inputs are host arrays read from results files."""
    out = []
    for t, p in zip(y_true_iter, y_pred_iter):
        t = np.asarray(t).ravel()
        p = np.asarray(p).ravel()
        out.append(float(np.mean(t == p)) if t.size else 0.0)
    return np.array(out)


def pearson_r(x, y, axis: int = -1):
    """Pearson correlation along ``axis``."""
    xc = x - x.mean(axis, keepdim=True)
    yc = y - y.mean(axis, keepdim=True)
    num = (xc * yc).sum(axis)
    den = torch.sqrt((xc**2).sum(axis) * (yc**2).sum(axis))
    return num / den.clamp(min=torch.finfo(x.dtype).tiny)


def _pearson_p_two_sided(r, n: int):
    """Two-sided p-value of a Pearson r over n samples (t-distribution,
    the ``scipy.stats.pearsonr`` null): p = I_{df/(df+t^2)}(df/2, 1/2).

    Computed on the host in float64 with ``scipy.special.betainc`` (torch
    has none; the JAX package calls ``jax.scipy.special.betainc``): r is
    one scalar a condition or dimension, so the copy is small. Returned as
    a tensor of r's dtype on r's device."""
    from scipy.special import betainc

    df = float(n - 2)
    r2 = np.clip(r.detach().double().cpu().numpy() ** 2, 0.0, 1.0)
    with np.errstate(divide="ignore"):
        t2 = r2 * df / np.maximum(1.0 - r2, 0.0)  # inf at |r| == 1: p = 0
    p = betainc(df / 2.0, 0.5, df / (df + t2))
    return torch.as_tensor(p, dtype=r.dtype, device=r.device)


def pt_corr(target, to_corr, class_mask=None, p_vals: bool = False):
    """Alignment quality: per-condition Pearson r between aligned latents.

    The reference contract (alignment/metrics.py:41-68): each condition's
    (T, K) trajectory is flattened across time and features and correlated,
    giving ONE r per condition.

    Args:
        target, to_corr: (n_classes, T, K) aligned condition-averaged
            trajectories.
        class_mask: optional (n_classes,) validity; invalid conditions get
            r = 0, p = 1.
        p_vals: also return two-sided p-values (``pearsonr`` null, see
            :func:`_pearson_p_two_sided`).

    Returns:
        (n_classes,) per-condition r, or (r, p) when ``p_vals``.
    """
    C = target.shape[0]
    a = target.reshape(C, -1)
    b = to_corr.reshape(C, -1)
    r = pearson_r(a, b, axis=-1)
    if class_mask is not None:
        r = r * class_mask.to(r.dtype)
    if not p_vals:
        return r
    p = _pearson_p_two_sided(r, a.shape[1])
    if class_mask is not None:
        p = torch.where(class_mask > 0, p, torch.ones_like(p))
    return r, p


def pt_corr_multi(target, to_corr_list, class_mask=None,
                  p_vals: bool = False):
    """``pt_corr`` of a target view against several comparison views
    (reference ``pt_corr_multi``, alignment/metrics.py:12-39).

    Returns:
        (n_views, n_classes) per-condition correlations, or a
        (correlations, p_values) pair of that shape when ``p_vals``.
    """
    out = [pt_corr(target, c, class_mask, p_vals) for c in to_corr_list]
    if p_vals:
        return (torch.stack([o[0] for o in out]),
                torch.stack([o[1] for o in out]))
    return torch.stack(out)


def pt_corr_dims(L_a, L_b, class_mask=None):
    """Per-latent-dim alignment quality: Pearson r along time for each
    (condition, dim), averaged over valid conditions.

    Returns:
        (K,) per-dim correlation averaged over valid classes.
    """
    r = pearson_r(L_a.movedim(1, -1), L_b.movedim(1, -1), axis=-1)  # (C, K)
    if class_mask is None:
        return r.mean(0)
    w = class_mask.to(r.dtype)[:, None]
    return (r * w).sum(0) / w.sum().clamp(min=1.0)

def edit_distance(pred, pred_len, target, target_len):
    """Levenshtein distances between padded integer sequences.

    Args:
        pred: (B, P), pred_len: (B,), target: (B, L), target_len: (B,).

    Returns:
        (B,) float32 distances.

    Wagner-Fischer over the padded lengths, vectorised over the batch and
    the target axis: one DP row per prediction symbol. Within a row,
    dp[i+1][j] = min(u[j], dp[i+1][j-1] + 1) with
    u[j] = min(dp[i][j] + 1, dp[i][j-1] + cost) is a running minimum of
    u[k] + (j - k), so it is ``cummin(u - j) + j``.
    """
    B, P = pred.shape
    L = target.shape[1]
    dev = pred.device
    big = float(P + L + 1)
    j = torch.arange(L + 1, device=dev, dtype=torch.float32)
    in_target = j[None, :] <= target_len[:, None]  # (B, L+1)
    row = torch.where(in_target, j.expand(B, L + 1), big)
    cost = (pred[:, :, None] != target[:, None, :]).float()  # (B, P, L)
    for i in range(P):
        u = torch.minimum(row[:, 1:] + 1.0, row[:, :-1] + cost[:, i])
        u = torch.cat([row[:, :1] + 1.0, u], dim=1)  # dp[i+1][0] = i + 1
        new = torch.cummin(u - j, dim=1).values + j
        new = torch.where(in_target, new, big)
        row = torch.where((i < pred_len)[:, None], new, row)
    return row.gather(1, target_len.long()[:, None])[:, 0]


def per_batch(preds, pred_lens, targets, target_lens):
    """Phoneme error rate (%) = sum(edit distances) / sum(target lengths)
    * 100 (reference ``calc_PER``, realtime_nn_model.py:307-324)."""
    dists = edit_distance(preds, pred_lens, targets, target_lens)
    return dists.sum() / target_lens.sum().clamp(min=1) * 100.0
