"""Realtime latency analyses — the supp_fig_20 / supp_fig_24 flows.

The reference instruments no latency in code; its supplementary notebooks
(`figure_analyses/supp/supp_fig_20.ipynb`, `supp_fig_24.ipynb`) analyze
saved per-step decode-latency distributions offline. Here that analysis is
a tested function layer over the distributions the realtime simulator
persists (``run_realtime_sim(out=...)``):

- :func:`latency_report`: summary statistics + deadline-violation rate
  (the closed-loop budget is one 50 ms bin + margin, <60 ms end-to-end);
- :func:`latency_comparison`: pairwise Mann-Whitney U across conditions
  (e.g. hidden sizes, channel counts) with BH-FDR, the supp-figure
  statistical contract.

The port's copy of ``cross_patient_speech_decoding_tpu/analysis/
latency.py`` (numpy).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from .contexts import PairwiseRow
from .stats import fdr_bh, mann_whitney_u


def latency_report(samples_ms, deadline_ms: float = 60.0) -> dict:
    """Summary of one per-step latency distribution (milliseconds).

    Returns mean/p50/p90/p99/max plus the fraction of steps missing the
    closed-loop deadline. p99 is reported only with >=100 samples (below
    that it is effectively the max — see the bench's honesty rule).
    """
    s = np.asarray(samples_ms, np.float64)
    if s.size == 0:
        raise ValueError("empty latency distribution")
    out = {
        "n": int(s.size),
        "mean_ms": float(s.mean()),
        "p50_ms": float(np.percentile(s, 50)),
        "p90_ms": float(np.percentile(s, 90)),
        "p99_ms": float(np.percentile(s, 99)) if s.size >= 100 else None,
        "max_ms": float(s.max()),
        "deadline_ms": float(deadline_ms),
        "violation_rate": float((s > deadline_ms).mean()),
    }
    return out


def latency_comparison(groups: Mapping[str, np.ndarray],
                       alpha: float = 0.05) -> list[PairwiseRow]:
    """All pairwise Mann-Whitney U tests between latency distributions,
    BH-FDR corrected (independent samples — steps of different runs are
    unpaired, unlike the accuracy contexts)."""
    names = list(groups)
    if len(names) < 2:
        raise ValueError("need at least two latency groups to compare")
    pairs = [
        (names[i], names[j])
        for i in range(len(names)) for j in range(i + 1, len(names))
    ]
    stats, ps = [], []
    for a, b in pairs:
        r = mann_whitney_u(np.asarray(groups[a]), np.asarray(groups[b]))
        stats.append(float(r.statistic))
        ps.append(float(r.pvalue))
    rej, p_adj = fdr_bh(np.asarray(ps), alpha=alpha)
    return [
        PairwiseRow(a, b, s, p, float(pa), bool(rj))
        for (a, b), s, p, pa, rj in zip(pairs, stats, ps, p_adj, rej)
    ]
