"""Hypothesis tests and multiple-comparison control for decode distributions.

Native implementations of exactly the statistical routines the reference's
figure notebooks run over their (n_iter x n_fold) accuracy / PER arrays:

- Wilcoxon signed-rank over CTC contexts (`figure_analyses/fig_5.ipynb`
  "stats" cells: 4 pairwise context tests + FDR) and RSA conditions
  (`fig_2.ipynb`, `fig_6.ipynb`);
- Mann-Whitney U over silhouette distributions (`fig_2.ipynb` MWU cells);
- one-way ANOVA + Tukey HSD per patient and repeated-measures ANOVA +
  paired t follow-ups at the group level (`fig_4.ipynb` cells 16/18);
- Benjamini-Hochberg FDR (statsmodels ``fdrcorrection`` /
  ``scipy.stats.false_discovery_control`` semantics);
- paired sign-flip permutation test (`fig_6.ipynb` cell 53,
  ``permutation_test(..., permutation_type='samples')``).

Only `scipy.special` distribution CDFs (ndtr/stdtr/fdtrc — the
special-function layer, analogous to using LAPACK for an SVD) are
imported; all statistic computation, ranking, tie handling, exact
enumeration, and the studentized-range integral are implemented here and
parity-tested against ``scipy.stats`` oracles in tests/test_analysis.py.

Everything accepts leading batch axes where noted, so a whole
contexts x patients table is evaluated in one call.

The port's copy of ``cross_patient_speech_decoding_tpu/analysis/stats.py``:
the same names and the same numerics (numpy and ``scipy.special``).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
from scipy.special import fdtrc, ndtr, stdtr


class TestResult(NamedTuple):
    statistic: np.ndarray
    pvalue: np.ndarray


def _rankdata(a: np.ndarray) -> np.ndarray:
    """Average ranks (ties shared) of a 1-D array, 1-based."""
    a = np.asarray(a, np.float64)
    sorter = np.argsort(a, kind="stable")
    inv = np.empty_like(sorter)
    inv[sorter] = np.arange(a.size)
    s = a[sorter]
    obs = np.r_[True, s[1:] != s[:-1]]
    dense = obs.cumsum()[inv]  # 1-based dense rank
    # boundaries[k] = count of elements in the first k tie-groups
    boundaries = np.r_[np.nonzero(obs)[0], a.size]
    return 0.5 * (boundaries[dense] + boundaries[dense - 1] + 1)


def _batched(fn, *arrays, n_out=2):
    """Apply a 1-D-sample test over the last axis of broadcast arrays."""
    arrays = [np.asarray(a, np.float64) for a in arrays]
    shape = np.broadcast_shapes(*[a.shape[:-1] for a in arrays])
    outs = [np.empty(shape, np.float64) for _ in range(n_out)]
    for idx in np.ndindex(shape):
        res = fn(*[a[(Ellipsis if a.ndim == 1 else idx)] for a in arrays])
        for o, r in zip(outs, res):
            o[idx] = r
    if not shape:
        return tuple(float(o) for o in outs)
    return tuple(outs)


# ---------------------------------------------------------------------------
# Wilcoxon signed-rank
# ---------------------------------------------------------------------------


def _signed_rank_exact_cdf_counts(ranks: np.ndarray) -> np.ndarray:
    """counts[t] = #sign assignments with positive-rank-sum == t.

    DP over subset sums of the (integer) ranks; exact path is only taken
    with no ties so ranks are 1..n.
    """
    total = int(round(ranks.sum()))
    c = np.zeros(total + 1, np.float64)
    c[0] = 1.0
    for r in ranks:
        r = int(round(r))
        c[r:] += c[:-r]
    return c


def _wilcoxon_1d(x, y=None, zero_method="wilcox", alternative="two-sided",
                 method="auto"):
    d = np.asarray(x, np.float64) - (0.0 if y is None else np.asarray(y))
    n_zero = int(np.sum(d == 0))
    if zero_method == "wilcox":
        d = d[d != 0]
    n = d.size
    if n == 0:
        return np.nan, np.nan
    absd = np.abs(d)
    r = _rankdata(absd)
    r_plus = float(np.sum(r[d > 0]))
    r_minus = float(np.sum(r[d < 0]))
    if zero_method == "zsplit":
        r_zero = float(np.sum(r[d == 0]))
        r_plus += r_zero / 2.0
        r_minus += r_zero / 2.0
    has_ties = np.unique(absd).size != n
    if method == "auto":
        method = "exact" if (n <= 50 and not has_ties and n_zero == 0) else "approx"
    elif method == "exact" and (has_ties or n_zero > 0):
        # the exact subset-sum distribution assumes integer ranks 1..n;
        # tied |d| produce half-integer average ranks (scipy warns and
        # falls back here too) -> use the tie-corrected normal approx
        import warnings

        warnings.warn(
            "exact Wilcoxon requested with ties/zeros present; "
            "falling back to the normal approximation",
            stacklevel=3,
        )
        method = "approx"

    if method == "exact":
        counts = _signed_rank_exact_cdf_counts(r)
        total = counts.sum()
        t = int(round(r_plus))
        cdf = counts[: t + 1].sum() / total
        sf = counts[t:].sum() / total
        if alternative == "two-sided":
            p = min(1.0, 2.0 * min(cdf, sf))
        elif alternative == "greater":
            p = sf
        else:
            p = cdf
    else:
        mn = n * (n + 1) / 4.0
        se2 = n * (n + 1) * (2 * n + 1) / 24.0
        # tie correction (scipy: sum(t^3 - t) / 48)
        _, tie_counts = np.unique(absd, return_counts=True)
        se2 -= np.sum(tie_counts**3 - tie_counts) / 48.0
        se = np.sqrt(se2)
        z = (r_plus - mn) / se
        if alternative == "two-sided":
            p = 2.0 * (1.0 - ndtr(abs(z)))
        elif alternative == "greater":
            p = 1.0 - ndtr(z)
        else:
            p = ndtr(z)
        p = min(1.0, p)
    stat = min(r_plus, r_minus) if alternative == "two-sided" else r_plus
    return stat, p


def wilcoxon_signed_rank(x, y=None, *, zero_method="wilcox",
                         alternative="two-sided", method="auto") -> TestResult:
    """Wilcoxon signed-rank test, batched over leading axes.

    Semantics of ``scipy.stats.wilcoxon`` (the reference's fig_5/fig_6
    context-comparison test): exact distribution when n <= 50 with no
    ties/zeros, else normal approximation with tie correction. Degenerate
    samples (all differences zero, where scipy raises) return NaN —
    :func:`fdr_bh` excludes NaNs from the correction.
    """
    fn = lambda *a: _wilcoxon_1d(*a, zero_method=zero_method,
                                 alternative=alternative, method=method)
    args = (x,) if y is None else (x, y)
    s, p = _batched(fn, *args)
    return TestResult(np.asarray(s), np.asarray(p))


# ---------------------------------------------------------------------------
# Mann-Whitney U
# ---------------------------------------------------------------------------


def _mwu_exact_sf(u: float, n1: int, n2: int) -> float:
    """P(U >= u) under H0 — exact, no ties.

    Counts size-n1 subsets of ranks {1..n1+n2} by rank-sum w (DP over
    items, tracked by subset size); U = w - n1(n1+1)/2.
    """
    n = n1 + n2
    max_w = n * (n + 1) // 2
    c = np.zeros((n1 + 1, max_w + 1), np.float64)
    c[0, 0] = 1.0
    for i in range(1, n + 1):
        c[1:, i:] += c[:-1, : max_w + 1 - i].copy()
    counts = c[n1]  # counts[w] = #subsets of size n1 with rank-sum w
    offset = n1 * (n1 + 1) // 2
    k = int(np.ceil(u)) + offset
    return counts[k:].sum() / counts.sum()


def _mannwhitneyu_1d(x, y, alternative="two-sided", method="auto",
                     use_continuity=True):
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    n1, n2 = x.size, y.size
    both = np.concatenate([x, y])
    ranks = _rankdata(both)
    r1 = float(np.sum(ranks[:n1]))
    u1 = r1 - n1 * (n1 + 1) / 2.0
    u2 = n1 * n2 - u1
    has_ties = np.unique(both).size != n1 + n2
    if method == "auto":
        method = "exact" if (min(n1, n2) <= 8 and not has_ties) else "approx"

    if method == "exact":
        if alternative == "two-sided":
            p = min(1.0, 2.0 * _mwu_exact_sf(max(u1, u2), n1, n2))
        elif alternative == "greater":
            p = _mwu_exact_sf(u1, n1, n2)
        else:
            p = _mwu_exact_sf(u2, n1, n2)
    else:
        mu = n1 * n2 / 2.0
        n = n1 + n2
        _, tie_counts = np.unique(both, return_counts=True)
        tie_term = np.sum(tie_counts**3 - tie_counts) / (n * (n - 1))
        sigma = np.sqrt(n1 * n2 / 12.0 * ((n + 1) - tie_term))
        cc = 0.5 if use_continuity else 0.0
        if alternative == "two-sided":
            z = (max(u1, u2) - mu - cc) / sigma
            p = min(1.0, 2.0 * (1.0 - ndtr(z)))
        elif alternative == "greater":
            p = 1.0 - ndtr((u1 - mu - cc) / sigma)
        else:
            p = 1.0 - ndtr((u2 - mu - cc) / sigma)
    return u1, p


def mann_whitney_u(x, y, *, alternative="two-sided", method="auto") -> TestResult:
    """Mann-Whitney U (``scipy.stats.mannwhitneyu`` semantics), batched.

    The reference's fig_2 silhouette-vs-chance comparison.
    """
    fn = lambda a, b: _mannwhitneyu_1d(a, b, alternative=alternative,
                                       method=method)
    s, p = _batched(fn, x, y)
    return TestResult(np.asarray(s), np.asarray(p))


# ---------------------------------------------------------------------------
# t tests / ANOVA
# ---------------------------------------------------------------------------


def ttest_rel(a, b, *, alternative="two-sided") -> TestResult:
    """Paired t test over the last axis (fig_4 group follow-ups)."""
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    n = d.shape[-1]
    md = d.mean(-1)
    sd = d.std(-1, ddof=1)
    t = md / (sd / np.sqrt(n))
    df = n - 1
    cdf = stdtr(df, t)
    if alternative == "two-sided":
        p = 2.0 * stdtr(df, -np.abs(t))
    elif alternative == "greater":
        p = 1.0 - cdf
    else:
        p = cdf
    return TestResult(t, p)


def ttest_ind(a, b, *, alternative="two-sided") -> TestResult:
    """Two-sample pooled-variance t test over the last axis."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    n1, n2 = a.shape[-1], b.shape[-1]
    v1, v2 = a.var(-1, ddof=1), b.var(-1, ddof=1)
    df = n1 + n2 - 2
    sp = np.sqrt(((n1 - 1) * v1 + (n2 - 1) * v2) / df)
    t = (a.mean(-1) - b.mean(-1)) / (sp * np.sqrt(1.0 / n1 + 1.0 / n2))
    if alternative == "two-sided":
        p = 2.0 * stdtr(df, -np.abs(t))
    elif alternative == "greater":
        p = 1.0 - stdtr(df, t)
    else:
        p = stdtr(df, t)
    return TestResult(t, p)


def f_oneway(*groups) -> TestResult:
    """One-way ANOVA over k groups (arrays over their last axis).

    Reference: per-patient context ANOVA, fig_4 cell 16.
    """
    groups = [np.asarray(g, np.float64) for g in groups]
    k = len(groups)
    ns = np.array([g.shape[-1] for g in groups])
    n_tot = ns.sum()
    means_list = [g.mean(-1) for g in groups]
    means = np.stack(means_list, -1)
    grand = sum(g.sum(-1) for g in groups) / n_tot
    ss_between = (ns * (means - grand[..., None]) ** 2).sum(-1)
    ss_within = sum(((g - m[..., None]) ** 2).sum(-1)
                    for g, m in zip(groups, means_list))
    df_b, df_w = k - 1, n_tot - k
    f = (ss_between / df_b) / (ss_within / df_w)
    return TestResult(f, fdtrc(df_b, df_w, f))


def anova_rm(data) -> TestResult:
    """Repeated-measures one-way ANOVA on (..., n_subjects, k_conditions).

    Matches ``statsmodels.stats.anova.AnovaRM`` with one within factor
    (fig_4 cell 18). With k = 2 it satisfies F == ttest_rel.t**2 (tested).
    """
    x = np.asarray(data, np.float64)
    n, k = x.shape[-2], x.shape[-1]
    grand = x.mean((-1, -2), keepdims=True)
    m_cond = x.mean(-2, keepdims=True)
    m_subj = x.mean(-1, keepdims=True)
    ss_cond = n * ((m_cond - grand) ** 2).sum((-1, -2))
    ss_err = ((x - m_cond - m_subj + grand) ** 2).sum((-1, -2))
    df_c, df_e = k - 1, (n - 1) * (k - 1)
    f = (ss_cond / df_c) / (ss_err / df_e)
    return TestResult(f, fdtrc(df_c, df_e, f))


# ---------------------------------------------------------------------------
# Tukey HSD (studentized range by quadrature)
# ---------------------------------------------------------------------------


def _studentized_range_cdf(q: float, k: int, df: float) -> float:
    """P(Q <= q) for the studentized range of k groups with df error dof.

    Double quadrature: inner Gauss-Legendre over the standard-normal
    location z of the range minimum, outer Gauss-Legendre over the scaled
    error s.d. s (s^2 ~ chi2_df / df). Accurate to ~1e-6 for the k/df
    regimes in the experiments (k <= 8, df >= 4).
    """
    if q <= 0:
        return 0.0

    zs, zw = np.polynomial.legendre.leggauss(120)
    lo, hi = -9.0, 9.0 + q
    z = 0.5 * (hi - lo) * zs + 0.5 * (hi + lo)
    zw = 0.5 * (hi - lo) * zw
    phi_z = np.exp(-0.5 * z * z) / np.sqrt(2 * np.pi)

    def inner(qs: np.ndarray) -> np.ndarray:
        # P(range of k std normals <= qs) for each scaled width qs
        diff = ndtr(z[None, :]) - ndtr(z[None, :] - qs[:, None])
        vals = k * phi_z[None, :] * np.clip(diff, 0.0, 1.0) ** (k - 1)
        return vals @ zw

    if not np.isfinite(df):
        return float(inner(np.array([q]))[0])

    # outer: s in (0, s_hi); chi_df/sqrt(df) density
    s_hi = 1.0 + 15.0 / np.sqrt(df)
    ss, sw = np.polynomial.legendre.leggauss(160)
    s = 0.5 * s_hi * (ss + 1.0)
    sw = 0.5 * s_hi * sw
    # log-density of s: s^2*df ~ chi2_df
    from scipy.special import gammaln

    logf = ((df / 2.0) * np.log(df) - gammaln(df / 2.0)
            - (df / 2.0 - 1.0) * np.log(2.0)
            + (df - 1.0) * np.log(np.maximum(s, 1e-300)) - df * s * s / 2.0)
    fs = np.exp(logf)
    return float(np.clip(np.sum(sw * fs * inner(q * s)), 0.0, 1.0))


class TukeyResult(NamedTuple):
    statistic: np.ndarray  # (k, k) pairwise mean differences
    pvalue: np.ndarray  # (k, k) FWER-adjusted p-values


def tukey_hsd(*groups: Sequence[float]) -> TukeyResult:
    """Tukey's honestly-significant-difference test (fig_4 cell 16).

    ``scipy.stats.tukey_hsd`` semantics: statistic[i, j] = mean_i - mean_j,
    p via the studentized range with nu = N - k and the Tukey-Kramer
    unequal-n standard error.
    """
    gs = [np.asarray(g, np.float64).ravel() for g in groups]
    k = len(gs)
    ns = np.array([g.size for g in gs], np.float64)
    means = np.array([g.mean() for g in gs])
    df = ns.sum() - k
    mse = sum(((g - m) ** 2).sum() for g, m in zip(gs, means)) / df
    stat = means[:, None] - means[None, :]
    se = np.sqrt(mse / 2.0 * (1.0 / ns[:, None] + 1.0 / ns[None, :]))
    qobs = np.abs(stat) / se
    p = np.ones((k, k))
    for i in range(k):
        for j in range(k):
            if i != j:
                p[i, j] = 1.0 - _studentized_range_cdf(qobs[i, j], k, df)
    return TukeyResult(stat, p)


# ---------------------------------------------------------------------------
# FDR + permutation
# ---------------------------------------------------------------------------


def fdr_bh(pvals, *, alpha: float = 0.05, axis: int = -1):
    """Benjamini-Hochberg FDR correction along ``axis``.

    Matches statsmodels ``fdrcorrection`` (fig_2/fig_4/fig_6) and
    ``scipy.stats.false_discovery_control`` (fig_5). Returns
    (reject, p_adjusted).
    """
    p = np.asarray(pvals, np.float64)
    p = np.moveaxis(p, axis, -1)
    # NaN p-values (degenerate tests, e.g. Wilcoxon on all-zero paired
    # diffs) stay NaN and are EXCLUDED from the correction count — one
    # degenerate pair must not poison every other comparison
    valid = np.isfinite(p)
    n = valid.sum(axis=-1, keepdims=True)
    p_sort = np.where(valid, p, np.inf)
    order = np.argsort(p_sort, axis=-1)
    ranked = np.take_along_axis(p_sort, order, -1) * n / np.arange(
        1, p.shape[-1] + 1
    )
    adj = np.minimum.accumulate(ranked[..., ::-1], axis=-1)[..., ::-1]
    adj = np.clip(adj, 0.0, 1.0)
    out = np.empty_like(adj)
    np.put_along_axis(out, order, adj, -1)
    out = np.where(valid, out, np.nan)
    out = np.moveaxis(out, -1, axis)
    reject = np.where(np.moveaxis(valid, -1, axis), out <= alpha, False)
    return reject, out


def cohens_d(a, b):
    """Cohen's d effect size with the pooled (n-1)-weighted standard
    deviation — the fig_4 notebook's ``cohend`` helper (fig_4.ipynb,
    effect-size cell).

    Scalar for 1-D inputs, an array over leading axes for stacked ones.
    Each group needs >= 2 samples (sample variance is undefined below
    that); two constant groups yield ``inf``/``nan`` like the notebook —
    flagged with a RuntimeWarning rather than silently.
    """
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    n1, n2 = a.shape[-1], b.shape[-1]
    if n1 < 2 or n2 < 2:
        raise ValueError("cohens_d needs >= 2 samples per group")
    s1 = a.var(-1, ddof=1)
    s2 = b.var(-1, ddof=1)
    s = np.sqrt(((n1 - 1) * s1 + (n2 - 1) * s2) / (n1 + n2 - 2))
    if np.any(s == 0):
        import warnings

        warnings.warn(
            "cohens_d: zero pooled variance; result is inf/nan",
            RuntimeWarning, stacklevel=2,
        )
    with np.errstate(divide="ignore", invalid="ignore"):
        d = (a.mean(-1) - b.mean(-1)) / s
    return d if d.ndim else float(d)


def paired_permutation_test(a, b, *, n_resamples: int = 9999, seed=0,
                            alternative="two-sided") -> TestResult:
    """Sign-flip permutation test of mean(a) - mean(b) on paired samples.

    ``scipy.stats.permutation_test((a, b), mean-diff,
    permutation_type='samples')`` semantics (fig_6 cell 53): exact
    enumeration of all 2^n sign patterns when feasible, else randomized
    with the +1 bias correction.
    """
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    n = d.shape[-1]
    obs = d.mean(-1)
    exact = 2**n <= n_resamples
    if exact:
        bits = (np.arange(2**n)[:, None] >> np.arange(n)[None, :]) & 1
        signs = 1.0 - 2.0 * bits  # (2^n, n)
    else:
        rng = np.random.default_rng(seed)
        signs = rng.choice([-1.0, 1.0], size=(n_resamples, n))
    null = (d[..., None, :] * signs).mean(-1)  # (..., n_perm)

    # scipy compares with a tiny numerical guard band
    gamma = 1e-14
    if alternative == "two-sided":
        hits = (np.abs(null) >= np.abs(obs)[..., None] - gamma).sum(-1)
    elif alternative == "greater":
        hits = (null >= obs[..., None] - gamma).sum(-1)
    else:
        hits = (null <= obs[..., None] + gamma).sum(-1)
    denom = signs.shape[0] + (0 if exact else 1)
    p = (hits + (0 if exact else 1)) / denom
    return TestResult(obs, np.minimum(p, 1.0))
