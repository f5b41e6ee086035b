"""Data-scaling analysis: log-linear PER extrapolation (fig_5 analysis).

The reference's fig_5 notebook fits ``scipy.stats.linregress`` on
log-transformed PER vs cross-patient trial counts and extrapolates the
number of trials needed to reach a target PER (SURVEY.md §2.8/§6). This
module provides that analysis as a tested function over sweep outputs.

The port's copy of ``cross_patient_speech_decoding_tpu/utils/scaling.py``
(numpy).
"""

from __future__ import annotations

import numpy as np


def log_linear_fit(trials: np.ndarray, per: np.ndarray):
    """Fit log(PER) = a * log(trials) + b.

    Returns dict with slope, intercept, r (Pearson of the log-log fit),
    and a predict(trials) callable.
    """
    trials = np.asarray(trials, np.float64)
    per = np.asarray(per, np.float64)
    lx, ly = np.log(trials), np.log(np.maximum(per, 1e-9))
    A = np.stack([lx, np.ones_like(lx)], axis=1)
    (slope, intercept), *_ = np.linalg.lstsq(A, ly, rcond=None)
    pred = slope * lx + intercept
    ssr = np.sum((ly - pred) ** 2)
    sst = np.sum((ly - ly.mean()) ** 2)
    r = np.sqrt(max(0.0, 1.0 - ssr / max(sst, 1e-12))) * np.sign(slope)
    # two-sided p-value for slope != 0 (scipy.stats.linregress semantics;
    # the supp_fig_18/19 analyses report it alongside slope/r)
    n = lx.size
    if n > 2 and sst > 1e-300:
        from scipy.special import stdtr

        se = np.sqrt(ssr / (n - 2) / np.sum((lx - lx.mean()) ** 2))
        tstat = slope / max(se, 1e-300)
        p = float(np.clip(2.0 * stdtr(n - 2, -abs(tstat)), 0.0, 1.0))
    else:
        p = float("nan")
    return {
        "slope": float(slope),
        "intercept": float(intercept),
        "r": float(r),
        "p_value": p,
        "predict": lambda t: np.exp(slope * np.log(t) + intercept),
    }


def trials_to_target_per(trials: np.ndarray, per: np.ndarray,
                         target_per: float = 25.0) -> float:
    """Extrapolated trial count at which the fit reaches ``target_per``
    (the reference's 'trials needed to reach 25% PER' figure statistic)."""
    fit = log_linear_fit(trials, per)
    if fit["slope"] >= 0:
        return float("inf")  # PER not improving with data
    expo = (np.log(target_per) - fit["intercept"]) / fit["slope"]
    if expo > 700.0:  # exp would overflow float64 — effectively unreachable
        return float("inf")
    return float(np.exp(expo))
