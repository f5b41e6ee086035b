"""Edit distance and phoneme error rate over padded batches.

Port of ``cross_patient_speech_decoding_tpu/ops/metrics.py:179-232``.
"""

from __future__ import annotations

import torch


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
