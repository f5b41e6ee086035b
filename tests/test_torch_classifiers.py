"""The port's kernel ridge classifiers, batched PCA and balanced accuracy
against the JAX package's, on the same numpy inputs made from a seed.

Both sides compute in float32 (JAX at Precision.HIGHEST, the port with
TF32 off); their products and Choleskys differ in rounding only.
Tolerances: dual coefficients and decision scores 1e-4 of the largest
JAX magnitude (float32 eps x cond of the 60 x 60 SPD system, ~4e3 for
the linear kernel at lam 0.5, bounds the solve's error by 2.4e-4; both
sides land within 2.3e-5 of each other here), ``scale_gamma`` and the
balanced weights 1e-6 relative, balanced accuracies 1e-6 absolute;
predictions equal wherever JAX's top two scores are apart by more than
1e-4 of their magnitude. Where the port batches what JAX fits one at a
time, JAX is looped over the rows. Batched ``pca_fit`` is held to a loop
of the unbatched call bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_patient_speech_decoding_tpu.ops import classifiers as jcl
from cross_patient_speech_decoding_tpu.ops import metrics as jmet
from cross_patient_speech_decoding_tpu.ops import pca as jpca
from cross_patient_speech_decoding_tpu_torch.ops import classifiers as tcl
from cross_patient_speech_decoding_tpu_torch.ops import metrics as tmet
from cross_patient_speech_decoding_tpu_torch.ops import pca as tpca
from cross_patient_speech_decoding_tpu_torch.ops.convert import (
    state_from_numpy,
)

torch.set_num_threads(2)

SCORE_RTOL = 1e-4
WEIGHT_RTOL = 1e-6
ACC_ATOL = 1e-6
DECIDED = 1e-4


def _data(seed=0, N=60, F=12, C=4, M=25):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(C, F)) * 1.5
    y = rng.integers(0, C, N)
    X = (centers[y] + rng.normal(size=(N, F))).astype(np.float32)
    yt = rng.integers(0, C, M)
    Xt = (centers[yt] + rng.normal(size=(M, F))).astype(np.float32)
    mask = (rng.random(N) > 0.3).astype(np.float32)
    fmask = np.ones(F, np.float32)
    fmask[-3:] = 0.0
    X[:, -3:] *= fmask[-3:]  # masked features are zero columns
    Xt[:, -3:] = 0.0
    return X, y.astype(np.int32), Xt, yt.astype(np.int32), mask, fmask


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _close(got, want, rtol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= rtol, f"{what}: {err:.3e} > {rtol:.1e}"


def _decided(scores):
    """Rows whose top two scores differ by more than DECIDED of their
    magnitude."""
    s = np.sort(np.asarray(scores, np.float64), axis=-1)
    top, second = s[..., -1], s[..., -2]
    return (top - second) > DECIDED * np.maximum(np.abs(top),
                                                 np.abs(second))


def _same_preds(pred, pred_j, scores_j):
    dec = _decided(scores_j)
    assert dec.mean() > 0.9
    np.testing.assert_array_equal(np.asarray(pred)[dec],
                                  np.asarray(pred_j)[dec])


@pytest.mark.parametrize("kernel", ["rbf", "linear"])
@pytest.mark.parametrize("balanced", [True, False])
def test_kernel_ridge_matches_jax(kernel, balanced):
    """Fit, decision and predict against JAX, with a sample mask and a
    feature mask; masked rows get exactly zero dual rows."""
    X, y, Xt, _, mask, fmask = _data()
    kw = dict(lam=0.5, kernel=kernel, balanced=balanced)
    clf_j = jcl.kernel_classifier_fit(
        jnp.asarray(X), jnp.asarray(y), 4, sample_mask=jnp.asarray(mask),
        feature_mask=jnp.asarray(fmask), **kw)
    clf = tcl.kernel_classifier_fit(
        _t(X), _t(y), 4, sample_mask=_t(mask), feature_mask=_t(fmask), **kw)
    _close(clf.gamma, clf_j.gamma, WEIGHT_RTOL, "gamma")
    _close(clf.dual_coef, clf_j.dual_coef, SCORE_RTOL, "dual")
    assert torch.all(clf.dual_coef[_t(mask) == 0] == 0)
    sc_j = jcl.kernel_classifier_decision(clf_j, jnp.asarray(Xt), kernel)
    sc = tcl.kernel_classifier_decision(clf, _t(Xt), kernel)
    _close(sc, sc_j, SCORE_RTOL, "decision")
    _same_preds(tcl.kernel_classifier_predict(clf, _t(Xt), kernel),
                jcl.kernel_classifier_predict(clf_j, jnp.asarray(Xt),
                                              kernel), sc_j)


def test_batched_fit_matches_jax_per_row():
    """A batch of fits (per-row masks, lam and gamma, one y) equals JAX
    fitted row by row; the default gamma is the per-row scale_gamma."""
    X, y, Xt, _, _, fmask = _data(seed=1)
    rng = np.random.default_rng(5)
    masks = (rng.random((3, X.shape[0])) > 0.25).astype(np.float32)
    lams = np.array([0.1, 1.0, 3.0], np.float32)
    gammas = np.array([0.02, 0.05, 0.1], np.float32)
    for gamma in (None, gammas):
        clf = tcl.kernel_classifier_fit(
            _t(X), _t(y), 4, lam=_t(lams), sample_mask=_t(masks),
            feature_mask=_t(fmask),
            gamma=None if gamma is None else _t(gamma))
        sc = tcl.kernel_classifier_decision(clf, _t(Xt)[None], "rbf")
        for b in range(3):
            clf_j = jcl.kernel_classifier_fit(
                jnp.asarray(X), jnp.asarray(y), 4, lam=float(lams[b]),
                sample_mask=jnp.asarray(masks[b]),
                feature_mask=jnp.asarray(fmask),
                gamma=None if gamma is None else float(gamma[b]))
            _close(clf.gamma[b], clf_j.gamma, WEIGHT_RTOL, "gamma")
            _close(sc[b], jcl.kernel_classifier_decision(
                clf_j, jnp.asarray(Xt), "rbf"), SCORE_RTOL, "decision")


def test_balanced_weights_and_scale_gamma_match_jax():
    X, y, _, _, mask, fmask = _data(seed=2)
    w_j = jcl.balanced_sample_weights(jnp.asarray(y), 5,
                                      jnp.asarray(mask))
    w = tcl.balanced_sample_weights(_t(y), 5, _t(mask))
    _close(w, w_j, WEIGHT_RTOL, "balanced weights")
    _close(tcl.balanced_sample_weights(_t(y), 5),
           jcl.balanced_sample_weights(jnp.asarray(y), 5), WEIGHT_RTOL)
    # batched: (2, N) masks against JAX per row; one row all-masked class
    masks = np.stack([mask, (y != 2).astype(np.float32)])
    wb = tcl.balanced_sample_weights(_t(y), 5, _t(masks))
    for b in range(2):
        _close(wb[b], jcl.balanced_sample_weights(
            jnp.asarray(y), 5, jnp.asarray(masks[b])), WEIGHT_RTOL)
    for sm, fm in ((None, None), (mask, None), (mask, fmask)):
        g_j = jcl.scale_gamma(jnp.asarray(X),
                              None if sm is None else jnp.asarray(sm),
                              None if fm is None else jnp.asarray(fm))
        g = tcl.scale_gamma(_t(X), None if sm is None else _t(sm),
                            None if fm is None else _t(fm))
        _close(g, g_j, WEIGHT_RTOL, "scale_gamma")
    fms = np.stack([fmask, np.ones_like(fmask)])
    gb = tcl.scale_gamma(_t(X), _t(masks), _t(fms))
    for b in range(2):
        _close(gb[b], jcl.scale_gamma(jnp.asarray(X), jnp.asarray(masks[b]),
                                      jnp.asarray(fms[b])), WEIGHT_RTOL)


def _jax_counts(seed, mask, n_est):
    """The bootstrap multiplicities of JAX's bagged_classifier_fit."""
    N = mask.shape[0]
    key = jax.random.key(seed)
    m = jnp.asarray(mask)
    p = m / jnp.maximum(jnp.sum(m), 1.0)
    draws = jax.vmap(
        lambda k: jax.random.categorical(k, jnp.log(p + 1e-30), shape=(N,))
    )(jax.random.split(key, n_est))
    return np.asarray(jax.vmap(
        lambda d: jnp.zeros((N,), jnp.float32).at[d].add(1.0))(draws))


@pytest.mark.parametrize("kernel", ["linear", "rbf"])
def test_bagging_apply_on_jax_counts(kernel):
    """The ensemble fitted from JAX's own bootstrap counts: every
    estimator's scores and the vote as JAX's bagged fit."""
    X, y, Xt, _, mask, fmask = _data(seed=3)
    counts = _jax_counts(7, mask, 5)
    clf_j = jcl.bagged_classifier_fit(
        jax.random.key(7), jnp.asarray(X), jnp.asarray(y), 4, 5,
        kernel=kernel, lam=0.5, sample_mask=jnp.asarray(mask),
        feature_mask=jnp.asarray(fmask))
    clf = tcl.bagged_classifier_fit_counts(
        _t(X), _t(y), 4, _t(counts), kernel=kernel, lam=0.5,
        feature_mask=_t(fmask))
    assert clf.dual_coef.shape == (5, X.shape[0], 4)
    _close(clf.gamma, clf_j.gamma, WEIGHT_RTOL, "gamma")
    _close(clf.dual_coef, clf_j.dual_coef, SCORE_RTOL, "dual")
    scores_j = np.asarray(jax.vmap(
        lambda c: jcl.kernel_classifier_decision(c, jnp.asarray(Xt), kernel)
    )(clf_j)).sum(0)
    _same_preds(tcl.bagged_classifier_predict(clf, _t(Xt), kernel),
                jcl.bagged_classifier_predict(clf_j, jnp.asarray(Xt),
                                              kernel), scores_j)


def test_bagging_draw_statistics():
    """The port's bootstrap draw: N draws an estimator, only from valid
    rows, uniform over them (chi-square over 2,000 estimators), the same
    uniforms for every row of a batch, reproducible from the seed."""
    N = 50
    mask = np.ones(N, np.float32)
    mask[::5] = 0.0
    masks = _t(np.stack([mask, mask, np.ones(N, np.float32)]))
    gen = torch.Generator().manual_seed(3)
    counts = tcl.bootstrap_counts_draw(gen, masks, 2000)
    assert counts.shape == (3, 2000, N)
    assert torch.all(counts.sum(-1) == N)
    assert torch.all(counts[:2, :, mask == 0] == 0)
    torch.testing.assert_close(counts[0], counts[1], rtol=0, atol=0)
    valid = counts[0][:, mask > 0].double()
    expect = N / valid.shape[1]
    chi2 = float(((valid.sum(0) - expect * 2000) ** 2
                  / (expect * 2000)).sum())
    dof = valid.shape[1] - 1
    assert chi2 < dof + 5 * (2 * dof) ** 0.5
    again = tcl.bootstrap_counts_draw(torch.Generator().manual_seed(3),
                                      masks, 2000)
    assert torch.equal(counts, again)


def test_non_pd_system_gives_nonfinite_scores():
    """A negative ridge makes the system indefinite: the Cholesky fails;
    JAX gives NaN coefficients, and so does the port (no exception), with
    the same argmax (the first NaN)."""
    X, y, Xt, _, _, _ = _data(seed=4)
    clf_j = jcl.kernel_classifier_fit(jnp.asarray(X), jnp.asarray(y), 4,
                                      lam=-50.0, kernel="linear")
    clf = tcl.kernel_classifier_fit(_t(X), _t(y), 4, lam=-50.0,
                                    kernel="linear")
    sc_j = np.asarray(jcl.kernel_classifier_decision(clf_j, jnp.asarray(Xt),
                                                     "linear"))
    sc = tcl.kernel_classifier_decision(clf, _t(Xt), "linear").numpy()
    assert not np.isfinite(sc_j).any()
    assert not np.isfinite(sc).any()
    np.testing.assert_array_equal(
        tcl.kernel_classifier_predict(clf, _t(Xt), "linear").numpy(),
        np.asarray(jcl.kernel_classifier_predict(clf_j, jnp.asarray(Xt),
                                                 "linear")))
    # one bad fit in a batch leaves the others finite
    clf_b = tcl.kernel_classifier_fit(_t(X), _t(y), 4,
                                      lam=_t(np.float32([-50.0, 1.0])),
                                      kernel="linear")
    assert not torch.isfinite(clf_b.dual_coef[0]).any()
    assert torch.isfinite(clf_b.dual_coef[1]).all()


def test_state_from_numpy_kernel_classifier():
    """A classifier fitted by JAX, carried across as numpy, predicts in the
    port as it does in JAX."""
    X, y, Xt, _, mask, _ = _data(seed=6)
    clf_j = jcl.kernel_classifier_fit(jnp.asarray(X), jnp.asarray(y), 4,
                                      sample_mask=jnp.asarray(mask))
    st = state_from_numpy(tcl.KernelClassifier,
                          {k: np.asarray(v)
                           for k, v in clf_j._asdict().items()},
                          device="cpu")
    assert st.dual_coef.dtype == torch.float32
    sc_j = jcl.kernel_classifier_decision(clf_j, jnp.asarray(Xt), "rbf")
    _close(tcl.kernel_classifier_decision(st, _t(Xt), "rbf"), sc_j,
           SCORE_RTOL, "decision")
    _same_preds(tcl.kernel_classifier_predict(st, _t(Xt), "rbf"),
                jcl.kernel_classifier_predict(clf_j, jnp.asarray(Xt), "rbf"),
                sc_j)


def test_balanced_accuracy_matches_jax_batched():
    rng = np.random.default_rng(8)
    yt = rng.integers(0, 5, (3, 40))
    yt[1][yt[1] == 4] = 0  # a class absent from one row
    yp = np.where(rng.random((3, 40)) < 0.6, yt, rng.integers(0, 5, (3, 40)))
    m = (rng.random((3, 40)) > 0.4).astype(np.float32)
    got = tmet.balanced_accuracy(_t(yt), _t(yp), 5, _t(m)).numpy()
    for b in range(3):
        want = float(jmet.balanced_accuracy(jnp.asarray(yt[b]),
                                            jnp.asarray(yp[b]), 5,
                                            jnp.asarray(m[b])))
        assert abs(got[b] - want) <= ACC_ATOL
    one = float(tmet.balanced_accuracy(_t(yt[0]), _t(yp[0]), 5))
    assert abs(one - float(jmet.balanced_accuracy(
        jnp.asarray(yt[0]), jnp.asarray(yp[0]), 5))) <= ACC_ATOL


def _pca_data(seed=9, B=4, N=50, F=10):
    rng = np.random.default_rng(seed)
    X = (rng.normal(size=(B, N, 4)) @ rng.normal(size=(4, F))
         + 0.3 * rng.normal(size=(B, N, F))).astype(np.float32)
    masks = (rng.random((B, N)) > 0.3).astype(np.float32)
    return X, masks


def _assert_states_equal(got, want):
    for name, g, w in zip(got._fields, got, want):
        assert torch.equal(g, w), name


@pytest.mark.parametrize("method", ["gram", "svd"])
@pytest.mark.parametrize("n_comp", ["fraction", "count"])
def test_batched_pca_fit_equals_unbatched_loop_bitwise(method, n_comp):
    """pca_fit over (B, N, F) data, (B, N) masks and per-row
    n_components equals B unbatched calls bit for bit; so does an
    unbatched X with (B, N) masks, and one with only per-row counts."""
    X, masks = _pca_data()
    nc = (torch.tensor([0.5, 0.8, 0.95, 0.7]) if n_comp == "fraction"
          else torch.tensor([2, 3, 5, 8], dtype=torch.int32))
    kw = dict(max_components=6, method=method)
    batched = tpca.pca_fit(_t(X), nc, sample_mask=_t(masks), **kw)
    shared = tpca.pca_fit(_t(X[0]), nc, sample_mask=_t(masks), **kw)
    per_row = tpca.pca_fit(_t(X[0]), nc, **kw)
    for b in range(4):
        _assert_states_equal(
            type(batched)(*(f[b] for f in batched)),
            tpca.pca_fit(_t(X[b]), nc[b], sample_mask=_t(masks[b]), **kw))
        _assert_states_equal(
            type(shared)(*(f[b] for f in shared)),
            tpca.pca_fit(_t(X[0]), nc[b], sample_mask=_t(masks[b]), **kw))
        one = tpca.pca_fit(_t(X[0]), nc[b], **kw)
        _assert_states_equal(
            type(per_row)(per_row.mean, *(f[b] for f in per_row[1:])), one)
        lat = tpca.pca_transform(per_row, _t(X[0]))[b]
        assert torch.equal(lat, tpca.pca_transform(one, _t(X[0])))


def test_batched_pca_per_row_fraction_matches_jax():
    """Per-row variance fractions pick JAX's component counts (JAX's
    traced fraction, row by row)."""
    X, masks = _pca_data(seed=10)
    fr = np.float32([0.55, 0.75, 0.9, 0.99])
    st = tpca.pca_fit(_t(X), _t(fr), max_components=8, method="gram",
                      sample_mask=_t(masks))
    for b in range(4):
        st_j = jpca.pca_fit(jnp.asarray(X[b]), jnp.asarray(fr[b]),
                            max_components=8, method="gram",
                            sample_mask=jnp.asarray(masks[b]))
        assert int(st.n_active[b]) == int(st_j.n_active)
        _close(st.explained_variance_ratio[b], st_j.explained_variance_ratio,
               2e-4, "evr")
