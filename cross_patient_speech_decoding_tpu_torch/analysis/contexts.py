"""Decoding-context comparison tables (fig_4 / fig_5 statistical flows).

Turns (n_distribution,) arrays per decoding context — e.g. per-patient
mean PER across 50 iterations for Chance / Patient-specific / Unaligned /
Aligned — into the exact statistics the reference notebooks print:

- ``context_comparison_table``: pairwise Wilcoxon + BH-FDR
  (fig_5 "stats" cell: 4 ordered context pairs, FDR-corrected);
- ``anova_tukey_by_group``: one-way ANOVA + Tukey HSD per patient
  (fig_4 cell 16);
- ``rm_anova_followup``: repeated-measures ANOVA over subjects x contexts
  with paired-t follow-ups + FDR (fig_4 cell 18).

Port of ``cross_patient_speech_decoding_tpu/analysis/contexts.py``
(numpy; results pickles read with the port's ``load_pkl``).
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Sequence

import numpy as np

from .stats import anova_rm, f_oneway, fdr_bh, ttest_rel, tukey_hsd
from .stats import wilcoxon_signed_rank


class PairwiseRow(NamedTuple):
    a: str
    b: str
    statistic: float
    pvalue: float
    pvalue_fdr: float
    significant: bool


def context_comparison_table(
    groups: Mapping[str, np.ndarray],
    pairs: Sequence[tuple[str, str]] | None = None,
    *,
    alpha: float = 0.05,
    test=wilcoxon_signed_rank,
) -> list[PairwiseRow]:
    """Pairwise paired tests over named context distributions + BH-FDR.

    Default pairs = consecutive-plus-all ordered pairs like fig_5's
    chance/ps, ps/unaligned, ps/aligned, unaligned/aligned flow: all
    unordered pairs in mapping order.
    """
    names = list(groups)
    if pairs is None:
        pairs = [
            (names[i], names[j])
            for i in range(len(names))
            for j in range(i + 1, len(names))
        ]
    stats, pvals = [], []
    for a, b in pairs:
        res = test(np.asarray(groups[a]), np.asarray(groups[b]))
        stats.append(float(res.statistic))
        pvals.append(float(res.pvalue))
    reject, p_fdr = fdr_bh(np.array(pvals), alpha=alpha)
    return [
        PairwiseRow(a, b, s, p, float(pf), bool(r))
        for (a, b), s, p, pf, r in zip(pairs, stats, pvals, p_fdr, reject)
    ]


class AnovaTukeyRow(NamedTuple):
    group: str
    f_statistic: float
    anova_p: float
    tukey_statistic: np.ndarray  # (k, k)
    tukey_p: np.ndarray  # (k, k)


def anova_tukey_by_group(
    per_group: Mapping[str, Sequence[np.ndarray]],
) -> list[AnovaTukeyRow]:
    """fig_4 cell 16: per patient, one-way ANOVA across the k context
    distributions followed by Tukey HSD on the same groups."""
    rows = []
    for name, dists in per_group.items():
        dists = [np.asarray(d, np.float64) for d in dists]
        f = f_oneway(*dists)
        tk = tukey_hsd(*dists)
        rows.append(
            AnovaTukeyRow(name, float(f.statistic), float(f.pvalue),
                          tk.statistic, tk.pvalue)
        )
    return rows


class RMAnovaResult(NamedTuple):
    f_statistic: float
    pvalue: float
    followups: list[PairwiseRow]


def rm_anova_followup(
    table: np.ndarray,
    context_names: Sequence[str],
    *,
    alpha: float = 0.05,
) -> RMAnovaResult:
    """fig_4 cell 18: RM-ANOVA on a (n_subjects, k_contexts) table of
    per-patient mean accuracies, then all pairwise ``ttest_rel``
    follow-ups with BH-FDR correction."""
    table = np.asarray(table, np.float64)
    rm = anova_rm(table)
    k = table.shape[1]
    pairs = [(i, j) for i in range(k) for j in range(i + 1, k)]
    stats, pvals = [], []
    for i, j in pairs:
        t = ttest_rel(table[:, i], table[:, j])
        stats.append(float(t.statistic))
        pvals.append(float(t.pvalue))
    reject, p_fdr = fdr_bh(np.array(pvals), alpha=alpha)
    rows = [
        PairwiseRow(context_names[i], context_names[j], s, p, float(pf), bool(r))
        for (i, j), s, p, pf, r in zip(pairs, stats, pvals, p_fdr, reject)
    ]
    return RMAnovaResult(float(rm.statistic), float(rm.pvalue), rows)


def prediction_records_from_results(path):
    """Per-iteration (y_true, y_pred, wrong_trs) lists from a driver
    results pickle written with ``save_preds`` — the reference's
    ``out_data['y_true'/'y_pred'/'wrong_trs']`` lists that the fig_3
    confusion-matrix cells consume (aligned_decode_svm_ncv.py:440-445)."""
    from cross_patient_speech_decoding_tpu_torch.data.loaders import load_pkl

    store = load_pkl(path)
    recs = [e for e in store.get("extra", []) if "y_pred" in e]
    if not recs:
        raise KeyError(
            f"{path} holds no prediction records (run with save_preds=true)"
        )
    return (
        [r["y_true"] for r in recs],
        [r["y_pred"] for r in recs],
        [r["wrong_trs"] for r in recs],
    )


def cmat_accuracy_from_results(path):
    """Per-iteration confusion-matrix accuracy over the saved pooled-fold
    predictions — ``cmat_wrap`` applied to a results pickle."""
    from cross_patient_speech_decoding_tpu_torch.ops.metrics import (
        cmat_acc_iter,
    )

    y_true, y_pred, _ = prediction_records_from_results(path)
    return cmat_acc_iter(y_true, y_pred)
