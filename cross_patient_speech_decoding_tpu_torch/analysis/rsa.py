"""Representational-similarity analysis (fig_6 machinery).

Reference: `figure_analyses/fig_6.ipynb` cell 15 — per-patient RDMs via
1 - Pearson r between condition-averaged, time-flattened trial tensors;
RDM comparison via Pearson r of the upper triangles restricted to
condition labels shared by both patients. The pairwise Pearson loop
becomes one correlation-matrix product.

The port's copy of ``cross_patient_speech_decoding_tpu/analysis/rsa.py``
(numpy).
"""

from __future__ import annotations

import numpy as np


def rdm_correlation(data: np.ndarray, labels: np.ndarray):
    """Representational dissimilarity matrix, 1 - corr method.

    Args:
      data: (n_trials, n_time, n_features) trial tensor.
      labels: (n_trials,) condition ids (any hashable dtype; sequence
        labels should be pre-encoded with ``utils.labels``).

    Returns:
      (rdm, unique_labels): (n_cnds, n_cnds) matrix and the sorted label
      universe, for shared-condition subsetting across patients.
    """
    data = np.asarray(data, np.float64)
    n_trials = data.shape[0]
    flat = data.reshape(n_trials, -1)
    uniq, inv = np.unique(np.asarray(labels), return_inverse=True)
    onehot = np.eye(uniq.size)[inv]  # (n_trials, n_cnds)
    ca = (onehot.T @ flat) / onehot.sum(0)[:, None]  # condition averages
    rdm = 1.0 - np.corrcoef(ca)
    return rdm, uniq


def subset_rdm(rdm: np.ndarray, labels: np.ndarray,
               keep_labels: np.ndarray) -> np.ndarray:
    """Rows+cols of ``rdm`` restricted to ``keep_labels`` (order of
    ``keep_labels``)."""
    labels = np.asarray(labels)
    idx = np.array([np.nonzero(labels == lab)[0][0] for lab in keep_labels])
    return rdm[np.ix_(idx, idx)]


def compare_rdms(rdm1, labels1, rdm2, labels2) -> float:
    """Pearson r between the upper triangles of two RDMs on their shared
    condition labels (fig_6 ``compare_rdms``)."""
    shared = np.intersect1d(np.asarray(labels1), np.asarray(labels2))
    r1 = subset_rdm(np.asarray(rdm1), labels1, shared)
    r2 = subset_rdm(np.asarray(rdm2), labels2, shared)
    iu = np.triu_indices_from(r1, k=1)
    a, b = r1[iu], r2[iu]
    a = a - a.mean()
    b = b - b.mean()
    denom = np.sqrt((a @ a) * (b @ b))
    return float(a @ b / denom) if denom > 0 else float("nan")
