"""The port's TME and mode-shuffle surrogates (``data/surrogates.py``) and
``cpsd svm-decode surrogate=tme|shuffle`` against the JAX package's, on
the CPU at small sizes.

Tolerances: the mode scatter matrices and the mode-shuffle surrogate are
the same numpy and gather work, compared bit for bit. ``fit_tme`` runs
the JAX package's float32 loss and optax's Adam in the same order of
operations, but XLA and PyTorch round exp, log and the reductions their
own ways: after 20 steps the log-parameters within 1e-5, the implied
eigenvalues within 1e-5 of their largest and the loss within 1e-5 of
itself; after 400 steps the implied eigenvalues within 1e-4 of their
largest. ``sample_tme``'s apply on JAX's own normal draw within 1e-5 of
JAX's sample (three float32 mode rotations). The port's draw comes from a
``torch.Generator`` and is held by JAX's statistical test. Driver
accuracies follow the decided-trial rule of tests/test_torch_decoders.py
(1e-6 plus the weight of the test trials whose top two scores lie within
1e-4 of their magnitude).
"""

import jax
import numpy as np
import pytest
import torch

from cross_patient_speech_decoding_tpu.cli import experiments as je
from cross_patient_speech_decoding_tpu.data import surrogates as jsur
from cross_patient_speech_decoding_tpu.data import synthetic as jsyn
from cross_patient_speech_decoding_tpu.utils.config import (
    SVMDecodeConfig as JaxCfg,
)
from cross_patient_speech_decoding_tpu_torch.cli import experiments as te
from cross_patient_speech_decoding_tpu_torch.data import loaders as tload
from cross_patient_speech_decoding_tpu_torch.data import surrogates as tsur
from cross_patient_speech_decoding_tpu_torch.decoders import pooled as tpool
from cross_patient_speech_decoding_tpu_torch.ops import classifiers as tcl
from cross_patient_speech_decoding_tpu_torch.utils.config import (
    SVMDecodeConfig,
)

torch.set_num_threads(2)

SHORT_STEPS, LONG_STEPS = 20, 400
SHORT_ATOL = 1e-5  # log-parameters; implied eigenvalues x their max; loss
LONG_RTOL = 1e-4  # implied eigenvalues x their max
APPLY_ATOL = 1e-5
TME_CRITERION = 0.05  # JAX's: implied vs data eigenvalues x the data's max
ACC_ATOL = 1e-6
DECIDED = 1e-4


@pytest.fixture(scope="module")
def X():
    """One patient's (48, 16, 10) float32 trials (JAX's TME test data)."""
    ds = jsyn.make_synthetic_patients(seed=0, n_patients=1, n_classes=4,
                                      trials_per_class=12, T=16,
                                      channels=(10,), latent_dim=3,
                                      noise=0.2)
    return np.asarray(ds.X[0], np.float32)


@pytest.fixture(scope="module")
def long_fits(X):
    return (jsur.fit_tme(X, steps=LONG_STEPS),
            tsur.fit_tme(X, steps=LONG_STEPS, device="cpu"))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_mode_covs_match_jax(X, dtype):
    covs, Xc = tsur._mode_covs(X.astype(dtype))
    covs_j, Xc_j = jsur._mode_covs(X.astype(dtype))
    np.testing.assert_array_equal(Xc, Xc_j)
    for c, c_j in zip(covs, covs_j):
        assert c.dtype == c_j.dtype
        np.testing.assert_array_equal(c, c_j)


def test_fit_tme_short_matches_jax(X):
    """20 Adam steps from the same initialisation: log-parameters,
    implied eigenvalues and loss; the data eigenvalues and the eigenbases
    equal."""
    fj = jsur.fit_tme(X, steps=SHORT_STEPS)
    ft = tsur.fit_tme(X, steps=SHORT_STEPS, device="cpu")
    assert set(ft) == set(fj)
    for a, b in zip(ft["log_abc"], fj["log_abc"]):
        assert a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=0, atol=SHORT_ATOL)
    for a, b in zip(ft["implied_eigs"], fj["implied_eigs"]):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=SHORT_ATOL * np.abs(b).max())
    for a, b in zip(ft["data_eigs"], fj["data_eigs"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ft["Qs"], fj["Qs"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ft["mean"], fj["mean"])
    assert abs(ft["final_loss"] - fj["final_loss"]) <= SHORT_ATOL * abs(
        fj["final_loss"])


def test_fit_tme_long_matches_jax_and_criterion(long_fits):
    """400 steps: the implied eigenvalues against JAX's, and both fits
    within JAX's 5 % criterion of the data's."""
    fj, ft = long_fits
    for a, b, d in zip(ft["implied_eigs"], fj["implied_eigs"],
                       ft["data_eigs"]):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=LONG_RTOL * np.abs(b).max())
        assert (np.abs(a - d).max() / d.max()) < TME_CRITERION


def test_sample_tme_apply_on_jax_draw(long_fits):
    """JAX's ``sample_tme`` draws ``jax.random.normal(key(seed))``; the
    port's apply on that draw gives JAX's sample."""
    fj, _ = long_fits
    shape = tuple(q.shape[0] for q in fj["Qs"])
    for seed in (0, 3):
        eps = np.array(jax.random.normal(jax.random.key(seed), shape))
        got = tsur.sample_tme_apply(fj, torch.from_numpy(eps))
        want = jsur.sample_tme(fj, seed=seed)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=APPLY_ATOL)


def test_sample_tme_draw_statistics(X, long_fits):
    """The port's own draw, held as JAX's test holds JAX's: a finite
    sample of X's shape, other seeds other samples, and the mean mode-1
    scatter of 20 draws projected on Q1 against the implied eigenvalues
    (tests/test_surrogates_and_utils.py's Gaussian tolerance)."""
    _, fit = long_fits
    surr, fit2 = tsur.tme_surrogate(X, steps=50, seed=0, device="cpu")
    assert surr.shape == X.shape and torch.isfinite(surr).all()
    assert set(fit2) == set(fit)
    s0 = tsur.sample_tme(fit, seed=0, device="cpu")
    assert torch.equal(s0, tsur.sample_tme(fit, seed=0, device="cpu"))
    s1 = tsur.sample_tme(fit, seed=1, device="cpu")
    assert (s0 - s1).abs().max() > 1e-3
    n_draws = 20
    acc = sum(tsur._mode_covs(tsur.sample_tme(
        fit, seed=100 + s, device="cpu").numpy().astype(np.float64))[0][0]
        for s in range(n_draws))
    Q1 = fit["Qs"][0]
    proj = np.diag(Q1.T @ (acc / n_draws) @ Q1)
    m1 = fit["implied_eigs"][0]
    la, lb, lc = fit["log_abc"]
    v = 1.0 / (np.exp(la)[:, None, None] + np.exp(lb)[None, :, None]
               + np.exp(lc)[None, None, :])
    std = np.sqrt(2.0 * (v ** 2).sum((1, 2))) / np.sqrt(n_draws)
    k = 3
    assert (np.abs(proj[:k] - m1[:k]) < 4.0 * std[:k] + 0.02 * m1.max()).all()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_mode_shuffle_matches_jax_bitwise(dtype):
    """The same generator gives the same surrogate, numpy or tensor input,
    and leaves the generator in the same state."""
    X = np.random.default_rng(1).normal(size=(30, 8, 6)).astype(dtype)
    rng_t, rng_j = np.random.default_rng(4), np.random.default_rng(4)
    got = tsur.mode_shuffle_surrogate(X, rng_t)
    want = jsur.mode_shuffle_surrogate(X, rng_j)
    assert got.dtype == torch.from_numpy(want).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    assert rng_t.integers(2**62) == rng_j.integers(2**62)
    rng_t = np.random.default_rng(4)
    np.testing.assert_array_equal(
        tsur.mode_shuffle_surrogate(torch.from_numpy(X), rng_t).numpy(), want)
    np.testing.assert_array_equal(np.sort(got.numpy(), 0), np.sort(X, 0))


# ------------------------------------------------------------- driver ----

SMALL = dict(synth_patients=3, synth_T=16, synth_trials=6, n_folds=4,
             n_iter=1, max_k=12, seed=3)


@pytest.fixture
def host_synth(monkeypatch):
    """Both drivers' synthetic data from the JAX package's host generator
    (tests/test_torch_svm_driver.py's fixture)."""
    monkeypatch.setattr(je, "make_synthetic_patients_device",
                        lambda **kw: jsyn.make_synthetic_patients(**kw))
    monkeypatch.setattr(te, "make_synthetic_patients_device",
                        lambda device=None, **kw:
                        jsyn.make_synthetic_patients(**kw))


@pytest.fixture
def surrogates(monkeypatch):
    """Each package's surrogate tensors, in the order the driver made
    them, the port's TME fits, and per decode of the port the test masks,
    the target's labels and the decision scores."""
    out = {"jax": [], "port": [], "fits": [], "decodes": [], "scores": []}
    for mod, key in ((jsur, "jax"), (tsur, "port")):
        shuffle, tme = mod.mode_shuffle_surrogate, mod.tme_surrogate

        def rec_shuffle(X, rng, _f=shuffle, _k=key):
            s = _f(X, rng)
            out[_k].append(np.asarray(s))
            return s

        def rec_tme(X, _f=tme, _k=key, **kw):
            s, fit = _f(X, **kw)
            out[_k].append(np.asarray(s))
            if _k == "port":
                out["fits"].append(fit)
            return s, fit

        monkeypatch.setattr(mod, "mode_shuffle_surrogate", rec_shuffle)
        monkeypatch.setattr(mod, "tme_surrogate", rec_tme)
    make, predict = tpool.make_cv_decoder, tpool.kernel_classifier_predict

    def make_rec(*a, **k):
        dec = make(*a, **k)

        def run(tar, cross, tr_m, te_m):
            out["decodes"].append((te_m.numpy(), tar.y.numpy()))
            return dec(tar, cross, tr_m, te_m)
        return run

    def scored(clf, X, kernel):
        out["scores"].append(tcl.kernel_classifier_decision(clf, X, kernel))
        return predict(clf, X, kernel)

    monkeypatch.setattr(tpool, "make_cv_decoder", make_rec)
    monkeypatch.setattr(tpool, "kernel_classifier_predict", scored)
    return out


def _assert_accs(accs, accs_j, rec):
    """Fold accuracies within 1e-6 plus the weight of the undecided test
    trials (one decoder call an iteration)."""
    assert accs.shape == accs_j.shape
    assert len(rec["decodes"]) == len(rec["scores"]) == len(accs)
    for a_t, a_j, (te, y), sc in zip(accs, accs_j, rec["decodes"],
                                     rec["scores"]):
        top2 = sc.double().topk(2, dim=-1).values.numpy()
        und = top2[..., 0] - top2[..., 1] <= DECIDED * np.abs(top2).max(-1)
        for f in range(len(te)):
            cls, support = np.unique(y[te[f] > 0], return_counts=True)
            w = dict(zip(cls, 1.0 / (len(cls) * support)))
            slack = sum(w[y[i]] for i in np.where((te[f] > 0) & und[f])[0])
            assert abs(a_t[f] - a_j[f]) <= ACC_ATOL + slack, (f, a_t, a_j)
    assert np.isfinite(accs).all()


@pytest.mark.parametrize("chance", [False, True])
def test_svm_decode_shuffle_matches_jax(tmp_path, host_synth, surrogates,
                                        chance):
    """surrogate=shuffle (after chance's permutation from the same
    generator): the surrogate tensors equal JAX's bit for bit, the fold
    accuracies by the decided-trial rule."""
    kw = dict(SMALL, surrogate="shuffle", chance=chance)
    accs_j = je.run_svm_decode(JaxCfg(out=str(tmp_path / "j.pkl"), **kw),
                               verbose=False)
    accs = te.run_svm_decode(SVMDecodeConfig(out=str(tmp_path / "t.pkl"),
                                             **kw),
                             verbose=False, device="cpu")
    assert len(surrogates["port"]) == len(surrogates["jax"]) == 2
    for got, want in zip(surrogates["port"], surrogates["jax"]):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    _assert_accs(accs, accs_j, surrogates)


def test_svm_decode_tme_runs_and_fits(tmp_path, host_synth, surrogates):
    """surrogate=tme: one TME fit of 1000 steps per cross patient on the
    run's device, each within JAX's 5 % criterion, and surrogates of the
    cross patients' shapes decoded to finite accuracies."""
    cfg = SVMDecodeConfig(out=str(tmp_path / "t.pkl"),
                          **dict(SMALL, surrogate="tme"))
    accs = te.run_svm_decode(cfg, verbose=False, device="cpu")
    assert accs.shape == (1, cfg.n_folds) and np.isfinite(accs).all()
    assert len(surrogates["fits"]) == cfg.synth_patients - 1
    for s, fit in zip(surrogates["port"], surrogates["fits"]):
        assert s.shape == tuple(q.shape[0] for q in fit["Qs"])
        assert np.isfinite(s).all()
        for d, m in zip(fit["data_eigs"], fit["implied_eigs"]):
            assert np.abs(m - d).max() / d.max() < TME_CRITERION
    assert len(tload.load_pkl(cfg.out)["accs"]) == 1
