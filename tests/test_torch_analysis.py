"""The port's analysis library against the JAX package's, from the same
numpy inputs: the statistics (a copy, within 1e-12), the context, latency
and RSA tables, the cluster scores (1e-5 relative to JAX, 1e-4 to
sklearn; the per-sample silhouettes 1e-4 absolute), t-SNE's affinities
(1e-5) and its loop on JAX's own draw (1e-4 x max |y|: the first 5
iterations whole, then each of 100 steps from a shared float64 state; the
loop is chaotic, so float32 rounding differences grow ~1000x every 10
iterations and two whole runs part after ~10), the PCA embedding up to
the port's sign rule, and the alignment-quality metrics: ``cmat_acc_iter``
exactly, Pearson r and p within 1e-5 (the port's p-values come from
``scipy.special.betainc`` on the host, JAX's from
``jax.scipy.special.betainc``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_patient_speech_decoding_tpu import analysis as ja
from cross_patient_speech_decoding_tpu.analysis import cluster as jcl
from cross_patient_speech_decoding_tpu.analysis import stats as jst
from cross_patient_speech_decoding_tpu.ops import metrics as jm
from cross_patient_speech_decoding_tpu_torch import analysis as ta
from cross_patient_speech_decoding_tpu_torch.analysis import cluster as tcl
from cross_patient_speech_decoding_tpu_torch.analysis import stats as tst
from cross_patient_speech_decoding_tpu_torch.data import loaders
from cross_patient_speech_decoding_tpu_torch.ops import metrics as tm

torch.set_num_threads(2)

STATS_TOL = 1e-12  # the statistics are a copy: the same numerics
CLUSTER_RTOL = 1e-5  # float32 products in another order
SKLEARN_RTOL = 1e-4
# one sample's silhouette: the |x|^2 + |y|^2 - 2xy distance expansion in
# float32 leaves ~2e-5 in JAX's own samples against float64
SAMPLE_ATOL = 1e-4
TSNE_TOL = 1e-4  # x max |y|
CORR_TOL = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _same(got, want, tol=STATS_TOL):
    """Every array of two (nested) results within ``tol`` (relative and
    absolute), NaNs in the same places."""
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w, tol)
        return
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol, equal_nan=True)


# ------------------------------------------------------------ statistics --


def _stat_cases():
    r = _rng(1)
    x10 = r.normal(size=10)
    y10 = x10 + r.normal(0.3, 1.0, size=10)
    tied = np.round(r.normal(size=60), 1)
    tied_y = np.round(tied + r.normal(0.1, 0.5, size=60), 1)
    tied_y[:5] = tied[:5]  # zero differences
    a, b, c = (r.normal(m, 1.0, size=n) for m, n in ((0, 12), (0.5, 15),
                                                      (1.2, 9)))
    table = r.normal(size=(8, 4)) + np.arange(4) * 0.3
    p = np.concatenate([r.uniform(0, 0.05, 5), r.uniform(0, 1, 15),
                        [np.nan]])
    batch = r.normal(size=(3, 12))
    return {
        "wilcoxon_exact": lambda m: m.wilcoxon_signed_rank(x10, y10),
        "wilcoxon_exact_less": lambda m: m.wilcoxon_signed_rank(
            x10, y10, alternative="less"),
        "wilcoxon_normal_ties_zeros": lambda m: m.wilcoxon_signed_rank(
            tied, tied_y),
        "wilcoxon_zsplit": lambda m: m.wilcoxon_signed_rank(
            tied, tied_y, zero_method="zsplit"),
        "wilcoxon_pratt": lambda m: m.wilcoxon_signed_rank(
            tied, tied_y, zero_method="pratt"),
        "wilcoxon_batched": lambda m: m.wilcoxon_signed_rank(
            batch, np.zeros(12)),
        "mann_whitney_exact": lambda m: m.mann_whitney_u(a[:7], b[:6]),
        "mann_whitney_ties": lambda m: m.mann_whitney_u(
            np.round(a, 0), np.round(b, 0)),
        "mann_whitney_greater": lambda m: m.mann_whitney_u(
            b, a, alternative="greater"),
        "ttest_rel": lambda m: m.ttest_rel(x10, y10),
        "ttest_ind": lambda m: m.ttest_ind(a, b),
        "ttest_ind_less": lambda m: m.ttest_ind(a, b, alternative="less"),
        "f_oneway": lambda m: m.f_oneway(a, b, c),
        "anova_rm": lambda m: m.anova_rm(table),
        "tukey_hsd": lambda m: m.tukey_hsd(a, b, c),
        "fdr_bh": lambda m: m.fdr_bh(p),
        "fdr_bh_batched": lambda m: m.fdr_bh(
            np.stack([p[:-1], p[::-1][1:]]), alpha=0.1),
        "cohens_d": lambda m: m.cohens_d(a, b),
        "permutation_exact": lambda m: m.paired_permutation_test(x10, y10),
        "permutation_random": lambda m: m.paired_permutation_test(
            tied, tied_y, n_resamples=999, seed=7),
    }


@pytest.mark.parametrize("case", sorted(_stat_cases()))
def test_stats_equal_jax(case):
    """Every public function of ``analysis/stats.py`` gives JAX's numbers
    within 1e-12."""
    fn = _stat_cases()[case]
    _same(fn(tst), fn(jst))


def test_stats_module_is_numpy_only():
    """The port's copy imports numpy and scipy.special only, and has JAX's
    public names."""
    src = tst.__file__
    text = open(src).read()
    assert "jax" not in text.replace("JAX", "")
    public = {n for n in dir(jst) if not n.startswith("_")
              and callable(getattr(jst, n))}
    assert public <= set(dir(tst))


# ------------------------------------------------- contexts, latency, rsa --


def _groups():
    r = _rng(2)
    return {name: r.normal(m, 0.05, size=12)
            for name, m in (("chance", 0.11), ("patient", 0.4),
                            ("unaligned", 0.42), ("aligned", 0.5))}


def _rows_same(got, want):
    """PairwiseRow lists: names and decisions equal, numbers within
    1e-12."""
    assert [(r.a, r.b, r.significant) for r in got] == [
        (r.a, r.b, r.significant) for r in want]
    _same([r[2:5] for r in got], [r[2:5] for r in want])


def test_context_tables_equal_jax():
    g = _groups()
    _rows_same(ta.context_comparison_table(g),
               ja.context_comparison_table(g))
    _rows_same(
        ta.context_comparison_table(g, test=tst.paired_permutation_test),
        ja.context_comparison_table(g, test=jst.paired_permutation_test))
    rows_t = ta.context_comparison_table(g, [("patient", "aligned")])
    rows_j = ja.context_comparison_table(g, [("patient", "aligned")])
    assert [r[:2] for r in rows_t] == [r[:2] for r in rows_j]
    assert [r.significant for r in rows_t] == [r.significant for r in rows_j]
    per = {"S14": list(g.values()), "S26": [v[::-1] for v in g.values()]}
    for rt, rj in zip(ta.anova_tukey_by_group(per),
                      ja.anova_tukey_by_group(per)):
        assert rt.group == rj.group
        _same(rt[1:], rj[1:])
    table = np.stack(list(g.values()), 1)
    rt = ta.rm_anova_followup(table, list(g))
    rj = ja.rm_anova_followup(table, list(g))
    _same(rt[:2], rj[:2])
    _rows_same(rt.followups, rj.followups)


def test_latency_tables_equal_jax():
    r = _rng(3)
    s = {"h128": r.gamma(4.0, 0.3, size=150),
         "h256": r.gamma(4.0, 0.35, size=120),
         "h512": r.gamma(5.0, 0.4, size=90)}
    for name in s:
        assert ta.latency_report(s[name]) == ja.latency_report(s[name])
    _rows_same(ta.latency_comparison(s), ja.latency_comparison(s))


def test_rsa_equal_jax():
    r = _rng(4)
    d1, d2 = r.normal(size=(40, 6, 5)), r.normal(size=(36, 6, 5))
    l1, l2 = r.integers(0, 8, 40), r.integers(2, 10, 36)
    rdm1, u1 = ta.rdm_correlation(d1, l1)
    rdm1_j, u1_j = ja.rdm_correlation(d1, l1)
    _same(rdm1, rdm1_j)
    np.testing.assert_array_equal(u1, u1_j)
    rdm2, u2 = ta.rdm_correlation(d2, l2)
    _same(ta.compare_rdms(rdm1, u1, rdm2, u2),
          ja.compare_rdms(rdm1, u1, rdm2, u2))
    keep = np.array([5, 2, 3])
    _same(ta.subset_rdm(rdm1, u1, keep), ja.subset_rdm(rdm1, u1, keep))


def test_prediction_records_and_cmat_accuracy(tmp_path):
    """A results pickle with saved predictions (written by the port's
    ``append_results_pkl``) reads back as JAX reads it."""
    r = _rng(5)
    path = tmp_path / "r.pkl"
    for _ in range(3):
        y = r.integers(0, 9, 40)
        p = np.where(r.random(40) < 0.6, y, r.integers(0, 9, 40))
        loaders.append_results_pkl(path, r.random(4), params={"a": 1},
                                   extra={"y_true": y, "y_pred": p,
                                          "wrong_trs": np.nonzero(y != p)[0]})
    got = ta.prediction_records_from_results(path)
    want = ja.prediction_records_from_results(path)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ta.cmat_accuracy_from_results(path),
                                  ja.cmat_accuracy_from_results(path))
    loaders.save_pkl({"accs": [np.ones(2)]}, tmp_path / "none.pkl")
    with pytest.raises(KeyError, match="save_preds"):
        ta.prediction_records_from_results(tmp_path / "none.pkl")


def test_cmat_acc_iter_equal():
    r = _rng(6)
    yt = [r.integers(0, 5, n) for n in (10, 0, 33)]
    yp = [np.where(r.random(t.size) < 0.5, t, 0) for t in yt]
    got, want = tm.cmat_acc_iter(yt, yp), jm.cmat_acc_iter(yt, yp)
    assert got.tolist() == want.tolist() and got.dtype == want.dtype


# ------------------------------------------------------- cluster scores --


def _blobs(n=90, k=3, f=6, seed=7, spread=1.5):
    r = _rng(seed)
    centers = r.normal(0, 3.0, size=(k, f))
    labels = np.repeat(np.arange(k), n // k)
    x = centers[labels] + r.normal(0, spread, size=(labels.size, f))
    return x.astype(np.float32), labels


@pytest.mark.parametrize("name", ["silhouette_samples", "silhouette_mean",
                                  "calinski_harabasz", "davies_bouldin"])
def test_cluster_scores_equal_jax_and_sklearn(name):
    from sklearn import metrics as skm

    x, labels = _blobs()
    labels = np.array(["b", "a", "c"])[labels]  # any hashable labels
    labels[0] = "d"  # a singleton cluster: sklearn gives it 0
    port, jax_, sk = {
        "silhouette_samples": (tcl.silhouette_samples, jcl.silhouette_samples,
                               skm.silhouette_samples),
        "silhouette_mean": (tcl.silhouette_positive_mean,
                            jcl.silhouette_positive_mean,
                            lambda x, y: float(np.mean(
                                [v for v in skm.silhouette_samples(x, y)
                                 if v > 0]))),
        "calinski_harabasz": (tcl.calinski_harabasz, jcl.calinski_harabasz,
                              skm.calinski_harabasz_score),
        "davies_bouldin": (tcl.davies_bouldin, jcl.davies_bouldin,
                           skm.davies_bouldin_score),
    }[name]
    got = np.asarray(port(x, labels, device="cpu"))
    want_jax = np.asarray(jax_(x, labels))
    want_sk = np.asarray(sk(x.astype(np.float64), labels))
    if name == "silhouette_samples":
        assert got[0] == 0.0 and got.shape == (x.shape[0],)
        np.testing.assert_allclose(got, want_jax, rtol=0, atol=SAMPLE_ATOL)
        np.testing.assert_allclose(got, want_sk, rtol=0, atol=SAMPLE_ATOL)
        return
    np.testing.assert_allclose(got, want_jax, rtol=CLUSTER_RTOL)
    np.testing.assert_allclose(got, want_sk, rtol=SKLEARN_RTOL)


def test_pairwise_sq_dists_equal_jax():
    x, _ = _blobs(n=30)
    y = x[:7] + 1.0
    got = tcl.pairwise_sq_dists(torch.from_numpy(x), torch.from_numpy(y))
    want = jcl.pairwise_sq_dists(jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=CLUSTER_RTOL, atol=CLUSTER_RTOL)


def test_pca_embed_equal_jax_up_to_sign():
    """The port fixes each component's sign (largest loading positive);
    JAX keeps its solver's. Each column is JAX's or its negative, and the
    port's sign follows its rule."""
    x, _ = _blobs(n=60, f=8)
    got = tcl.pca_embed(x, 3, device="cpu")
    want = jcl.pca_embed(x, 3)
    assert got.shape == want.shape == (60, 3)
    for k in range(3):
        s = np.sign(got[:, k] @ want[:, k])
        np.testing.assert_allclose(got[:, k], s * want[:, k],
                                   rtol=1e-4, atol=1e-4 * np.abs(want).max())
    # the rule: the loading of largest magnitude is positive
    xc = x - x.mean(0)
    load = np.linalg.lstsq(xc, got, rcond=None)[0]  # (F, 3) loadings
    lead = load[np.abs(load).argmax(0), np.arange(3)]
    assert (lead > 0).all()


# ------------------------------------------------------------------ t-SNE --


def test_conditional_probs_equal_jax():
    x, _ = _blobs(n=50)
    d2 = np.array(jcl.pairwise_sq_dists(jnp.asarray(x)))
    want = np.asarray(jcl._conditional_probs(jnp.asarray(d2), 10.0))
    got = tcl._conditional_probs(torch.from_numpy(d2), 10.0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=CLUSTER_RTOL)
    np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-5)


def _jax_tsne_inputs(n=64, perplexity=15.0):
    x, _ = _blobs(n=n, k=4, f=10)
    d2 = jcl.pairwise_sq_dists(jnp.asarray(x))
    p_cond = jcl._conditional_probs(d2, perplexity)
    p_sym = jnp.maximum((p_cond + p_cond.T) / (2.0 * n), 1e-12)
    y0 = 1e-4 * jax.random.normal(jax.random.key(3), (n, 2), jnp.float32)
    return x, p_sym, y0


def test_tsne_run_on_jax_draw():
    """The port's loop applied to JAX's affinities and JAX's ``y0`` (64
    points, the auto learning rate 50, the first 50 iterations
    exaggerated): the first 5 iterations, over which the embedding grows
    ~10^5-fold, within 1e-4 x max |y| of JAX's jitted loop; and the first
    5 with no exaggerated iteration, so that JAX itself holds the
    un-exaggerated branch (momentum 0.8, P as it is) too. Rounding
    differences then grow ~1000x every 10 iterations (sign flips of the
    adaptive gains), so whole runs are held step by step
    (:func:`test_tsne_steps_along_a_trajectory`)."""
    x, p_sym, y0 = _jax_tsne_inputs()
    p_t = torch.from_numpy(np.array(p_sym))
    y0_t = torch.from_numpy(np.array(y0))
    for exaggerated in (50, 0):
        for it in range(1, 6):
            want = np.asarray(jcl._tsne_run(p_sym, y0, it, exaggerated, 50.0))
            got = tcl._tsne_run(p_t, y0_t, it, exaggerated, 50.0).numpy()
            scale = np.abs(want).max()
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=TSNE_TOL * scale)
        if exaggerated:
            assert scale > 1.0  # grown from 1e-4
    # the port's affinities from the same points agree with JAX's too
    p_port = tcl._tsne_p(torch.from_numpy(x), 15.0).numpy()
    np.testing.assert_allclose(p_port, np.asarray(p_sym), rtol=0,
                               atol=CLUSTER_RTOL / x.shape[0])


def _np_tsne_step(y, vel, gains, p, momentum, lr):
    """The JAX package's loop body in float64 numpy."""
    d2 = ((y[:, None] - y[None]) ** 2).sum(-1)
    w = 1.0 / (1.0 + d2)
    np.fill_diagonal(w, 0.0)
    q = w / max(w.sum(), 1e-12)
    pq = (p - q) * w
    g = 4.0 * (y * pq.sum(1, keepdims=True) - pq @ y)
    gains = np.clip(np.where(np.sign(g) == np.sign(vel), gains * 0.8,
                             gains + 0.2), 0.01, None)
    vel = momentum * vel - lr * gains * g
    y = y + vel
    return y - y.mean(0), vel, gains


def test_tsne_steps_along_a_trajectory():
    """Each of 100 steps (50 exaggerated at momentum 0.5, 50 at 0.8) of
    the port's ``_tsne_step`` from the float64 loop's state, within 1e-4 x
    max |y| of the float64 step; ``_tsne_run`` is those steps."""
    _, p_sym, y0 = _jax_tsne_inputs()
    p = np.asarray(p_sym, np.float64)
    y, vel, gains = (np.asarray(y0, np.float64), np.zeros((64, 2)),
                     np.ones((64, 2)))
    off = 1.0 - torch.eye(64)
    for i in range(100):
        early = i < 50
        pi = p * 12.0 if early else p
        mom = 0.5 if early else 0.8
        got = tcl._tsne_step(*(torch.from_numpy(a).float()
                               for a in (y, vel, gains, pi)), off, mom, 50.0)
        y, vel, gains = _np_tsne_step(y, vel, gains, pi, mom, 50.0)
        np.testing.assert_allclose(got[0].numpy(), y, rtol=0,
                                   atol=TSNE_TOL * np.abs(y).max())
    assert np.abs(y).max() > 1.0


def test_tsne_y0_draw_statistics():
    """The initial embedding is 1e-4 x a standard normal from a host
    generator: the same for a seed, another for another seed, with the
    normal's mean and spread (JAX's ``jax.random`` stream is not
    reproduced)."""
    a = tcl._tsne_y0(4000, 2, 0)
    assert a.shape == (4000, 2) and a.device.type == "cpu"
    assert torch.equal(a, tcl._tsne_y0(4000, 2, 0))
    assert not torch.equal(a, tcl._tsne_y0(4000, 2, 1))
    z = a.double().numpy().ravel() / 1e-4
    assert abs(z.mean()) < 4.0 / np.sqrt(z.size)
    assert abs(z.std() - 1.0) < 0.05
    assert abs(np.corrcoef(z[0::2], z[1::2])[0, 1]) < 0.1


def test_tsne_embed_recovers_blobs():
    x, labels = _blobs(n=60, k=3, f=8, spread=0.5)
    y = tcl.tsne_embed(x, perplexity=10.0, n_iter=250, seed=0, device="cpu")
    assert y.shape == (60, 2) and np.isfinite(y).all()
    assert tcl.silhouette_positive_mean(y, labels, device="cpu") > 0.5


# --------------------------------------------------- alignment quality --


def _trajectories(seed=8, C=6, T=20, K=4):
    r = _rng(seed)
    a = r.normal(size=(C, T, K)).astype(np.float32)
    b = (0.7 * a + r.normal(0, 0.8, size=a.shape)).astype(np.float32)
    mask = np.array([1, 1, 0, 1, 1, 0], np.float32)[:C]
    return a, b, mask


def test_pearson_and_pt_corr_equal_jax():
    a, b, mask = _trajectories()
    np.testing.assert_allclose(
        tm.pearson_r(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jm.pearson_r(jnp.asarray(a), jnp.asarray(b))),
        rtol=0, atol=CORR_TOL)
    for m in (None, mask):
        tmask = None if m is None else torch.from_numpy(m)
        jmask = None if m is None else jnp.asarray(m)
        r_t, p_t = tm.pt_corr(torch.from_numpy(a), torch.from_numpy(b),
                              tmask, p_vals=True)
        r_j, p_j = jm.pt_corr(jnp.asarray(a), jnp.asarray(b), jmask,
                              p_vals=True)
        assert r_t.dtype == p_t.dtype == torch.float32
        np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=0,
                                   atol=CORR_TOL)
        np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=0,
                                   atol=CORR_TOL)
        np.testing.assert_allclose(
            tm.pt_corr(torch.from_numpy(a), torch.from_numpy(b),
                       tmask).numpy(), np.asarray(r_j), rtol=0,
            atol=CORR_TOL)


@pytest.mark.parametrize("axis", [0, -1])
def test_pearson_r_takes_jax_axis_keyword(axis):
    """``pearson_r(x, y, axis=...)`` as in the JAX package, along either
    axis of (4, 50) arrays."""
    r = _rng(9)
    a = r.normal(size=(4, 50)).astype(np.float32)
    b = (0.5 * a + r.normal(size=a.shape)).astype(np.float32)
    got = tm.pearson_r(torch.from_numpy(a), torch.from_numpy(b), axis=axis)
    want = jm.pearson_r(jnp.asarray(a), jnp.asarray(b), axis=axis)
    assert got.shape == want.shape == ((50,) if axis == 0 else (4,))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=CORR_TOL)


def test_pt_corr_p_values_against_scipy():
    """The host float64 p-values are scipy's ``pearsonr`` null; |r| = 1
    gives p = 0."""
    from scipy.stats import pearsonr

    a, b, _ = _trajectories(seed=9)
    r, p = tm.pt_corr(torch.from_numpy(a), torch.from_numpy(b), p_vals=True)
    for c in range(a.shape[0]):
        want = pearsonr(a[c].ravel().astype(np.float64),
                        b[c].ravel().astype(np.float64))
        assert abs(float(r[c]) - want[0]) < CORR_TOL
        assert abs(float(p[c]) - want[1]) < CORR_TOL
    _, p1 = tm.pt_corr(torch.from_numpy(a), torch.from_numpy(2 * a),
                       p_vals=True)
    assert (p1 == 0).all()


def test_pt_corr_multi_and_dims_equal_jax():
    a, b, mask = _trajectories(seed=10)
    c = -b + 0.1
    views_t = [torch.from_numpy(b), torch.from_numpy(c)]
    views_j = [jnp.asarray(b), jnp.asarray(c)]
    r_t, p_t = tm.pt_corr_multi(torch.from_numpy(a), views_t,
                                torch.from_numpy(mask), p_vals=True)
    r_j, p_j = jm.pt_corr_multi(jnp.asarray(a), views_j, jnp.asarray(mask),
                                p_vals=True)
    assert r_t.shape == p_t.shape == (2, a.shape[0])
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=0,
                               atol=CORR_TOL)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=0,
                               atol=CORR_TOL)
    np.testing.assert_allclose(
        tm.pt_corr_multi(torch.from_numpy(a), views_t).numpy(),
        np.asarray(jm.pt_corr_multi(jnp.asarray(a), views_j)), rtol=0,
        atol=CORR_TOL)
    for m in (None, mask):
        got = tm.pt_corr_dims(torch.from_numpy(a), torch.from_numpy(b),
                              None if m is None else torch.from_numpy(m))
        want = jm.pt_corr_dims(jnp.asarray(a), jnp.asarray(b),
                               None if m is None else jnp.asarray(m))
        assert got.shape == (a.shape[2],)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=CORR_TOL)


def test_analysis_exports_match_jax():
    assert sorted(ta.__all__) == sorted(ja.__all__)
    for name in ja.__all__:
        assert callable(getattr(ta, name))
