"""CTC loss, greedy decoding and prefix beam search.

Port of ``cross_patient_speech_decoding_tpu/ops/ctc.py``. The loss is
``torch.nn.functional.ctc_loss``, the library counterpart of the JAX
package's optax call (no Pallas kernel is involved); greedy decoding runs
on tensors. :func:`prefix_beam_search` is host Python over numpy, the
oracle of the native beam search in ``realtime/beam.py``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def ctc_loss_mean(logits, input_lengths, labels, label_lengths,
                  blank_id: int = 0, weights=None):
    """CTC loss with torch ``CTCLoss(reduction='mean', zero_infinity=True)``
    semantics.

    Args:
        logits: (B, T, V) unnormalised scores (log_softmax applied here).
        input_lengths: (B,) valid logit frames.
        labels: (B, L) padded targets.
        label_lengths: (B,) valid target lengths.
        weights: optional (B,) sample weights: the reduction becomes a
            weighted mean over rows; ``None`` is the plain batch mean.

    Each sequence's loss is zeroed when infinite or above 1e4 (the JAX
    package's clamp, ctc.py:59), divided by max(label length, 1), then
    averaged.
    """
    T = logits.shape[1]
    log_probs = F.log_softmax(logits.float(), dim=-1).transpose(0, 1)
    il = input_lengths.long().clamp(0, T)
    ll = label_lengths.long()
    per_seq = F.ctc_loss(log_probs, labels.long(), il, ll, blank=blank_id,
                         reduction="none", zero_infinity=True)
    per_seq = torch.where(torch.isfinite(per_seq) & (per_seq <= 1e4),
                          per_seq, torch.zeros_like(per_seq))
    per_seq = per_seq / ll.clamp(min=1)
    if weights is None:
        return per_seq.mean()
    w = weights.to(per_seq.dtype)
    return (per_seq * w).sum() / w.sum().clamp(min=1.0)


def greedy_decode(log_probs, blank_id: int = 0, frame_mask=None):
    """Batched greedy CTC decode: argmax, collapse repeats, drop blanks.

    Args:
        log_probs: (B, T, V).
        frame_mask: optional (B, T) frame validity. Repeats are collapsed
            against the last valid frame, so [a, b(masked), a] is one a.

    Returns:
        (decoded (B, T) padded with ``blank_id``, lengths (B,)).
    """
    B, T, _ = log_probs.shape
    best = log_probs.argmax(dim=2)
    dev = best.device
    none = torch.full((B, 1), -1, dtype=best.dtype, device=dev)
    if frame_mask is None:
        prev = torch.cat([none, best[:, :-1]], dim=1)
        keep = (best != blank_id) & (best != prev)
    else:
        valid = frame_mask > 0
        t_idx = torch.arange(T, device=dev).expand(B, T)
        vpos = torch.where(valid, t_idx, torch.full_like(t_idx, -1))
        lb = torch.cummax(vpos, dim=1).values  # last valid index <= t
        lb = torch.cat([none, lb[:, :-1]], dim=1)
        prev = torch.where(lb >= 0, best.gather(1, lb.clamp(min=0)), none)
        keep = valid & (best != blank_id) & (best != prev)
    pos = keep.long().cumsum(dim=1) - 1
    lengths = (pos[:, -1] + 1).clamp(min=0)
    # kept symbols land left-aligned; dropped ones in a spill column T
    tgt = torch.where(keep, pos, torch.full_like(pos, T))
    out = torch.full((B, T + 1), blank_id, dtype=best.dtype, device=dev)
    out.scatter_(1, tgt, best)
    return out[:, :T], lengths


NEG_INF = -float("inf")


def _logsumexp2(a: float, b: float) -> float:
    if a == NEG_INF and b == NEG_INF:
        return NEG_INF
    m = max(a, b)
    return m + math.log(math.exp(a - m) + math.exp(b - m))


def prefix_beam_search(
    log_probs: np.ndarray, beam_size: int = 100, blank_id: int = 0
):
    """CTC prefix beam search (host-side; Hannun 2014 algorithm).

    Args:
        log_probs: (T, V) log-probabilities for one sequence.

    Returns:
        (best_prefix_tuple, neg_log_likelihood).

    ``realtime.beam.prefix_beam_search`` runs the C++ version of
    ``native/beam.cpp``; this pure-Python version is its fallback and test
    oracle.
    """
    T, V = log_probs.shape
    # beam entries: prefix -> (log p ending in blank, log p ending non-blank)
    beam = {(): (0.0, NEG_INF)}

    for t in range(T):
        row = log_probs[t]
        nxt: dict = {}

        def upd(prefix, pb, pnb):
            old = nxt.get(prefix, (NEG_INF, NEG_INF))
            nxt[prefix] = (_logsumexp2(old[0], pb), _logsumexp2(old[1], pnb))

        for prefix, (p_b, p_nb) in beam.items():
            total = _logsumexp2(p_b, p_nb)
            # extend with blank: prefix unchanged
            upd(prefix, total + row[blank_id], NEG_INF)
            last = prefix[-1] if prefix else None
            for s in range(V):
                if s == blank_id:
                    continue
                p = row[s]
                if s == last:
                    # repeat: merges unless separated by blank
                    upd(prefix, NEG_INF, p_nb + p)
                    upd(prefix + (s,), NEG_INF, p_b + p)
                else:
                    upd(prefix + (s,), NEG_INF, total + p)

        beam = dict(
            sorted(
                nxt.items(),
                key=lambda kv: _logsumexp2(*kv[1]),
                reverse=True,
            )[:beam_size]
        )

    best, (p_b, p_nb) = max(
        beam.items(), key=lambda kv: _logsumexp2(*kv[1])
    )
    return best, -_logsumexp2(p_b, p_nb)
