"""Decode-quality metrics: confusion-matrix accuracy, edit distance and
phoneme error rate over padded batches.

Port of ``cross_patient_speech_decoding_tpu/ops/metrics.py:19-58`` and
``:179-232``. ``balanced_accuracy`` takes leading batch dims (one score a
fold).
"""

from __future__ import annotations

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
