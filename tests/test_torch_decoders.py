"""The port's pooled decoders, nested search, TPE sampler and sklearn
estimators against the JAX package's, on the CPU at small sizes.

Both sides get the same host arrays (the JAX package's synthetic
generator) and the same numpy masks. Both sides are float32 with TF32
off, and their features differ in rounding (~2e-5 of the largest value
here), so a trial whose top two scores are nearly tied may go either way:
predictions are equal wherever the port's top two decision scores differ
by more than 1e-4 of their magnitude, fold accuracies within 1e-6 plus
the balanced-accuracy weight of the test trials not decided in that
sense (0 in most folds). Sklearn-surface
transforms 1e-3 of the largest value (tests/test_torch_alignment.py's
projection bound). Two draws cannot be shared and are fed across: the
port fixes each PCA component's sign (largest loading positive) where
JAX keeps its solver's, so sepDimRed runs here take JAX's signs; and
the bootstrap of the bagged head takes JAX's counts. The TPE proposals
and the inner splits are numpy and equal bit for bit.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_patient_speech_decoding_tpu.data import make_synthetic_patients
from cross_patient_speech_decoding_tpu.data.splits import (
    stratified_kfold_masks,
)
from cross_patient_speech_decoding_tpu.decoders import nested_cv as jnest
from cross_patient_speech_decoding_tpu.decoders import pooled as jpool
from cross_patient_speech_decoding_tpu.sweep import bayes as jbayes
from cross_patient_speech_decoding_tpu_torch.decoders import nested_cv as tnest
from cross_patient_speech_decoding_tpu_torch.decoders import pooled as tpool
from cross_patient_speech_decoding_tpu_torch.ops import cca, jacobi
from cross_patient_speech_decoding_tpu_torch.ops import classifiers as tcl
from cross_patient_speech_decoding_tpu_torch.sweep import bayes as tbayes

torch.set_num_threads(2)

ACC_ATOL = 1e-6
DECIDED = 1e-4
TRANSFORM_RTOL = 1e-3
ROOT = Path(__file__).resolve().parent.parent


def _f32(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)


@pytest.fixture(scope="module")
def data():
    """3 patients (target first), 6 classes x 8 trials, T=16, masks of 4
    stratified folds; both packages' PatientArrays of the same arrays."""
    ds = make_synthetic_patients(seed=0, n_patients=3, n_classes=6,
                                 trials_per_class=8, T=16,
                                 channels=(24, 30, 20), latent_dim=5,
                                 noise=3.0)
    uniq = np.unique(np.concatenate(ds.y_first))
    jp, tp = [], []
    for p in range(3):
        y = np.searchsorted(uniq, ds.y_first[p])
        jp.append(jpool.PatientArrays(jnp.asarray(ds.X[p]),
                                      jnp.asarray(y, jnp.int32),
                                      jnp.asarray(ds.class_ids[p],
                                                  jnp.int32)))
        tp.append(tpool.PatientArrays(torch.as_tensor(ds.X[p]),
                                      torch.as_tensor(y),
                                      torch.as_tensor(ds.class_ids[p]).long()))
    tr, te = stratified_kfold_masks(np.asarray(jp[0].y), 4,
                                    np.random.default_rng(0))
    cfg = dict(n_comp=0.9, max_k=10, n_classes=len(uniq),
               n_align_classes=ds.n_classes, lam=1e-2)
    return dict(ds=ds, jax=jp, port=tp, tr=tr, te=te, cfg=cfg)


@pytest.fixture
def jax_pca_signs(monkeypatch):
    """The port's fold-program PCA with JAX's component signs, so that
    sepDimRed pools the same features on both sides. JAX's signs come from
    its own fit of the same rows, vmapped over a batch of masks as its
    decoder vmaps folds: XLA's batched eigh picks other signs than its
    unbatched one."""
    def fit(X, n_comp, max_k, sample_mask=None):
        st = tpool._fit_pca_latents(X, n_comp, max_k, sample_mask)
        comp = st.components
        Xj = jnp.asarray(X.numpy())
        if sample_mask is None:
            comp_j = jpool._fit_pca_latents(Xj, n_comp, max_k).components
        else:
            comp_j = jax.jit(jax.vmap(
                lambda m: jpool._fit_pca_latents(Xj, n_comp, max_k,
                                                 m).components))(
                jnp.asarray(sample_mask.numpy()))
        dots = (comp * torch.from_numpy(np.array(comp_j))).sum(-2)
        signs = torch.where(dots < 0, -1.0, 1.0)
        st = st._replace(components=comp * signs[..., None, :])
        return st, tpool._transform_latents(st, X, max_k)

    monkeypatch.setattr(tpool, "_pca_latents", fit)


def _jax_counts(seed, mask, n_est):
    """The bootstrap multiplicities JAX's bagged fit draws for one row."""
    N = mask.shape[0]
    m = jnp.asarray(mask)
    p = m / jnp.maximum(jnp.sum(m), 1.0)
    draws = jax.vmap(
        lambda k: jax.random.categorical(k, jnp.log(p + 1e-30), shape=(N,))
    )(jax.random.split(jax.random.key(seed), n_est))
    return np.asarray(jax.vmap(
        lambda d: jnp.zeros((N,), jnp.float32).at[d].add(1.0))(draws))


@pytest.fixture
def jax_bootstrap(monkeypatch):
    """The port's bootstrap draw replaced by JAX's counts, row by row."""
    def draw(generator, sample_mask, n_est):
        seed = generator.initial_seed()
        rows = sample_mask.reshape(-1, sample_mask.shape[-1]).numpy()
        counts = np.stack([_jax_counts(seed, r, n_est) for r in rows])
        return torch.from_numpy(counts).reshape(
            sample_mask.shape[:-1] + counts.shape[1:])

    monkeypatch.setattr(tcl, "bootstrap_counts_draw", draw)


@pytest.fixture
def scores(monkeypatch):
    """The port's decision scores (summed over a bagged ensemble) of every
    fold batch, in order."""
    out = []
    predict, bagged = tpool.kernel_classifier_predict, \
        tpool.bagged_classifier_predict

    def rec(clf, X, kernel):
        out.append(tcl.kernel_classifier_decision(clf, X, kernel))
        return predict(clf, X, kernel)

    def rec_bag(clf, X, kernel):
        out.append(tcl.kernel_classifier_decision(
            clf, X[..., None, :, :], kernel).sum(-3))
        return bagged(clf, X, kernel)

    monkeypatch.setattr(tpool, "kernel_classifier_predict", rec)
    monkeypatch.setattr(tpool, "bagged_classifier_predict", rec_bag)
    return out


def _run_both(data, strategy, fold_batch=0, **over):
    cfg = dict(data["cfg"], **over)
    jp, tp = data["jax"], data["port"]
    ja, jpr = jpool.make_cv_decoder(strategy, jpool.DecodeConfig(**cfg),
                                    return_preds=True)(
        jp[0], tuple(jp[1:]), jnp.asarray(data["tr"]), jnp.asarray(data["te"]))
    ta, tpr = tpool.make_cv_decoder(strategy, tpool.DecodeConfig(**cfg),
                                    fold_batch=fold_batch, return_preds=True)(
        tp[0], tp[1:], _f32(data["tr"]), _f32(data["te"]))
    return (np.asarray(ja), np.asarray(jpr)), (ta.numpy(), tpr.numpy())


def _undecided(scores):
    """(B, N0) trials whose top two scores are within DECIDED of their
    magnitude."""
    top2 = torch.cat(scores).double().topk(2, dim=-1).values.numpy()
    gap = top2[..., 0] - top2[..., 1]
    return gap <= DECIDED * np.abs(top2).max(-1)


def _assert_same(jax_out, port_out, scores, y, te):
    """Predictions equal on decided trials; accuracies within the weight
    of the undecided test trials."""
    (ja, jpr), (ta, tpr) = jax_out, port_out
    assert ta.shape == ja.shape == (4,)
    assert 0.2 < ja.mean() < 0.999  # neither trivial nor saturated
    und = _undecided(scores)
    assert und.shape == tpr.shape and und.mean() < 0.05
    np.testing.assert_array_equal(tpr[~und], jpr[~und])
    for f in range(4):
        cls, support = np.unique(y[te[f] > 0], return_counts=True)
        w = dict(zip(cls, 1.0 / (len(cls) * support)))
        slack = sum(w[y[i]] for i in np.where((te[f] > 0) & und[f])[0])
        assert abs(ta[f] - ja[f]) <= ACC_ATOL + slack, (f, ta, ja)


@pytest.mark.parametrize("strategy,fold_batch", [
    ("sep_align", 0), ("sep_align", 3), ("sep_dimred", 3),
    ("joint_pca", 0), ("mcca", 3)])
def test_cv_decoder_matches_jax(data, strategy, fold_batch, jax_pca_signs,
                                scores):
    """Fold accuracies and predictions of each strategy against JAX's
    make_cv_decoder; fold_batch 3 splits the 4 folds in two batches."""
    _assert_same(*_run_both(data, strategy, fold_batch), scores,
                 data["port"][0].y.numpy(), data["te"])


@pytest.mark.parametrize("kernel", ["rbf", "linear"])
def test_cv_decoder_bagging_matches_jax(data, kernel, jax_bootstrap,
                                        scores):
    """The bagged head (3 estimators) from JAX's bootstrap counts; also
    without the target in the pool."""
    y = data["port"][0].y.numpy()
    _assert_same(*_run_both(data, "sep_align", 3, bagging=3, kernel=kernel,
                            lam=1.0), scores, y, data["te"])
    if kernel == "rbf":
        scores.clear()
        _assert_same(*_run_both(data, "sep_align", 0, bagging=3,
                                tar_in_train=False), scores, y, data["te"])


def test_fold_hyperparameters_match_jax(data, scores):
    """Per-fold hyperparameters (B,) in one batch: each fold as JAX's fold
    function with that fold's scalars (vmapped over the folds)."""
    jp, tp = data["jax"], data["port"]
    cfg = data["cfg"]
    hp = {"n_comp": np.float32([0.55, 0.95, 0.7, 0.9]),
          "lam": np.float32([1e-2, 10.0, 0.1, 1.0]),
          "gamma_scale": np.float32([0.3, 1.0, 3.0, 1.0])}
    acc, pred = tpool.decode_fold_sep_align(
        tp[0], tp[1:], _f32(data["tr"]), _f32(data["te"]),
        tpool.DecodeConfig(**cfg), hp={k: _f32(v) for k, v in hp.items()})
    a_j, p_j = jax.jit(jax.vmap(
        lambda tr, te, h: jpool.decode_fold_sep_align(
            jp[0], tuple(jp[1:]), tr, te, jpool.DecodeConfig(**cfg), hp=h)))(
        jnp.asarray(data["tr"]), jnp.asarray(data["te"]),
        {k: jnp.asarray(v) for k, v in hp.items()})
    _assert_same((np.asarray(a_j), np.asarray(p_j)),
                 (acc.numpy(), pred.numpy()), scores, tp[0].y.numpy(),
                 data["te"])


@pytest.fixture
def counted_kernel_route(monkeypatch):
    """The card's route on CPU tensors: the CCA's small SVD by the Gram
    route, batched_eigh to the kernel's wrapper, whose launches are
    counted and which runs the kernel's plain version."""
    svd = cca._svd_small
    monkeypatch.setattr(cca, "_svd_small",
                        lambda g, method, force_gram=None:
                        svd(g, method, True if method == "gram"
                            else force_gram))
    monkeypatch.setattr(jacobi, "_route", lambda A: "kernel")

    def launch(A, sweeps=8):
        jacobi.LAUNCHES["jacobi_eigh"] += 1
        return jacobi.jacobi_eigh_plain(
            A, jacobi._pairs_on(A.shape[-1], A.device), sweeps)

    monkeypatch.setattr(jacobi, "jacobi_eigh_cuda", launch)
    jacobi.reset_launch_counts()
    yield jacobi.LAUNCHES
    jacobi.reset_launch_counts()


def test_jacobi_launches_counted_on_cpu_plain_route(data,
                                                    counted_kernel_route):
    """sep_align launches the Jacobi wrapper once per source and fold
    batch, the nested search once per source and scoring or refit batch;
    the other strategies never. Every patient has 24 or more channels, so
    max_k = 24 (ANY_BATCH_K) gives each CCA fit a 24 x 24 Gram SVD, which
    takes the kernel at any batch."""
    ds = make_synthetic_patients(seed=1, n_patients=3, n_classes=6,
                                 trials_per_class=8, T=12,
                                 channels=(26, 30, 28), latent_dim=5,
                                 noise=3.0)
    tp = [tpool.PatientArrays(torch.as_tensor(ds.X[p]),
                              torch.as_tensor(ds.class_ids[p] % 4),
                              torch.as_tensor(ds.class_ids[p]).long())
          for p in range(3)]
    cfg = tpool.DecodeConfig(n_comp=0.95, max_k=24, n_classes=4,
                             n_align_classes=ds.n_classes)
    n_src = len(tp) - 1
    tr, te = _f32(data["tr"]), _f32(data["te"])
    tpool.make_cv_decoder("sep_align", cfg, fold_batch=3)(tp[0], tp[1:],
                                                          tr, te)
    assert counted_kernel_route["jacobi_eigh"] == n_src * 2  # ceil(4 / 3)
    for strategy in ("sep_dimred", "joint_pca", "mcca"):
        jacobi.reset_launch_counts()
        tpool.make_cv_decoder(strategy, cfg)(tp[0], tp[1:], tr, te)
        assert counted_kernel_route["jacobi_eigh"] == 0, strategy
    jacobi.reset_launch_counts()
    n_folds, rounds, points, inner, fit_batch = 4, 2, 2, 2, 8
    tnest.nested_cv_decode_bayes(tp[0], tp[1:], cfg, n_folds=n_folds,
                                 n_rounds=rounds, n_points=points,
                                 n_inner=inner, fit_batch=fit_batch)
    bs = max(1, fit_batch // (points * inner))
    batches = rounds * -(-n_folds // bs) + -(-n_folds // min(n_folds,
                                                             fit_batch))
    assert counted_kernel_route["jacobi_eigh"] == n_src * batches == 10


def test_tpe_and_random_proposals_match_jax_bitwise():
    space_j = {"a": jbayes.Float(0.5, 0.99),
               "b": jbayes.Float(1e-3, 1e2, log=True),
               "c": jbayes.Categorical((1, 2, 3))}
    space = {"a": tbayes.Float(0.5, 0.99),
             "b": tbayes.Float(1e-3, 1e2, log=True),
             "c": tbayes.Categorical((1, 2, 3))}
    r_j, r = np.random.default_rng(4), np.random.default_rng(4)
    hist_j = [(c, float(i % 5)) for i, c in
              enumerate(jbayes.sample_random(space_j, 12, r_j))]
    hist = [(c, float(i % 5)) for i, c in
            enumerate(tbayes.sample_random(space, 12, r))]
    assert hist == hist_j
    s_j = jbayes.TPESampler(space_j, seed=3).fit(hist_j)
    s = tbayes.TPESampler(space, seed=3).fit(hist)
    for n in (1, 5):
        assert s.propose(n) == s_j.propose(n)
    assert tbayes.default_ctc_space() == {
        k: type(space["a"])(*v.__dict__.values())
        if isinstance(v, jbayes.Float)
        else tbayes.Categorical(v.choices)
        for k, v in jbayes.default_ctc_space().items()}


def test_inner_cv_masks_match_jax_bitwise():
    y = np.repeat(np.arange(5), 9)
    r_j, r = np.random.default_rng(2), np.random.default_rng(2)
    tr, _ = stratified_kfold_masks(y, 4, np.random.default_rng(0))
    for k in range(4):
        for n_inner in (3, 10):  # 10 > class size: the KFold fallback
            got = tnest.inner_cv_masks(tr[k], y, n_inner, r)
            want = jnest.inner_cv_masks(tr[k], y, n_inner, r_j)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
    assert r.integers(1 << 30) == r_j.integers(1 << 30)


def test_nested_bayes_matches_jax(data):
    """Two TPE rounds of 3 points over 2 inner folds, then the refit: the
    same best hyperparameters, accuracies and predictions as JAX."""
    jp, tp = data["jax"], data["port"]
    kw = dict(n_folds=4, n_rounds=2, n_points=3, n_inner=2, seed=1,
              return_preds=True, fit_batch=12)
    a_j, hp_j, p_j, te_j = jnest.nested_cv_decode_bayes(
        jp[0], tuple(jp[1:]), jpool.DecodeConfig(**data["cfg"]), **kw)
    a, hp, p, te = tnest.nested_cv_decode_bayes(
        tp[0], tp[1:], tpool.DecodeConfig(**data["cfg"]), **kw)
    np.testing.assert_allclose(a, a_j, atol=ACC_ATOL)
    for k in hp_j:
        np.testing.assert_array_equal(hp[k].numpy(), np.asarray(hp_j[k]))
    np.testing.assert_array_equal(p, p_j)
    np.testing.assert_array_equal(te, te_j)


def test_nested_cv_decode_matches_jax(data):
    """The random-candidate nested decoder: candidates bit for bit, best
    index and accuracy per outer fold as JAX."""
    jp, tp = data["jax"], data["port"]
    kw = dict(n_folds=3, n_candidates=4, n_inner=2, seed=0)
    a_j, b_j, c_j = jnest.nested_cv_decode(
        jp[0], tuple(jp[1:]), jpool.DecodeConfig(**data["cfg"]), **kw)
    a, b, c = tnest.nested_cv_decode(
        tp[0], tp[1:], tpool.DecodeConfig(**data["cfg"]), **kw)
    for k in c_j:
        np.testing.assert_array_equal(c[k].numpy(), np.asarray(c_j[k]))
    np.testing.assert_array_equal(b, np.asarray(b_j))
    np.testing.assert_allclose(a, a_j, atol=ACC_ATOL)


def test_mesh_raises_with_its_item(data):
    """The decoders' ``mesh=`` paths on two gloo ranks
    (``torch_parallel_ranks.decode_checks``): ``make_cv_decoder`` with its
    4 folds sharded, the nested scorer and refit with 3 outer folds
    (padded to 4 by a repeated fold), ``nested_cv_decode_bayes`` and
    ``nested_cv_decode`` (3 outer folds) give
    the one-device port's accuracies (atol 1e-6), predictions and scores
    (every rank batches its block as the one device batches all, by
    ``fit_batch``)."""
    import torch_parallel_ranks as ranks

    from cross_patient_speech_decoding_tpu_torch import parallel

    cfg = tpool.DecodeConfig(**data["cfg"])
    tp = data["port"]
    y = tp[0].y.numpy()
    rng = np.random.default_rng(2)
    tr3, te3 = stratified_kfold_masks(y, 3, rng)
    itr = np.zeros((3, 2, len(y)))
    ite = np.zeros((3, 2, len(y)))
    for k in range(3):
        itr[k], ite[k] = tnest.inner_cv_masks(tr3[k], y, 2, rng)
    hp = {"n_comp": rng.uniform(0.6, 0.95, (3, 2)),
          "lam": rng.uniform(0.01, 1.0, (3, 2)),
          "gamma_scale": np.ones((3, 2))}
    bayes = dict(n_folds=3, n_rounds=2, n_points=2, n_inner=2, seed=1,
                 fit_batch=12)
    random = dict(n_folds=3, n_candidates=4, n_inner=2, seed=0)
    spec = dict(pts=[tuple(t.numpy() for t in p) for p in tp],
                cfg=data["cfg"], tr=data["tr"], te=data["te"], fold_batch=3,
                fit_batch=4, itr=itr, ite=ite, hp=hp, tr3=tr3, te3=te3,
                bayes=bayes, random=random)
    got = parallel.launch(ranks.decode_checks, 2, (spec,), devices="cpu",
                          timeout=120)

    with ranks.threads(1):
        accs, preds = tpool.make_cv_decoder(
            "sep_align", cfg, fold_batch=3, return_preds=True)(
            tp[0], tp[1:], _f32(data["tr"]), _f32(data["te"]))
        score, final = tnest.make_candidate_scorer("sep_align", cfg,
                                                   fit_batch=4)
        hp_t = {k: _f32(v) for k, v in hp.items()}
        scores = score(tp[0], tp[1:], _f32(itr), _f32(ite), hp_t)
        f_accs, f_preds = final(tp[0], tp[1:], _f32(tr3), _f32(te3),
                                {k: v[:, 0] for k, v in hp_t.items()})
        b_accs, _ = tnest.nested_cv_decode_bayes(tp[0], tp[1:], cfg,
                                                 **bayes)
        r_accs, r_best, _ = tnest.nested_cv_decode(tp[0], tp[1:], cfg,
                                                   **random)
    np.testing.assert_allclose(got["accs"], accs.numpy(), atol=ACC_ATOL)
    np.testing.assert_array_equal(got["preds"], preds.numpy())
    assert got["scores"].shape == (3, 2)
    np.testing.assert_allclose(got["scores"], scores.numpy(), atol=ACC_ATOL)
    # an intended difference: each rank keeps fit_batch (4 fits: one outer
    # fold x 2 candidates x 2 inner folds a call) on its 2 outer folds,
    # where JAX's mesh path scores a device's block in one program
    assert got["score_fits"] == [4, 4]
    np.testing.assert_allclose(got["final_accs"], f_accs.numpy(),
                               atol=ACC_ATOL)
    np.testing.assert_array_equal(got["final_preds"], f_preds.numpy())
    np.testing.assert_allclose(got["bayes_accs"], b_accs, atol=ACC_ATOL)
    np.testing.assert_allclose(got["random_accs"], r_accs, atol=ACC_ATOL)
    np.testing.assert_array_equal(got["random_best"], r_best)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_only_sklearn_compat_imports_sklearn():
    """scikit-learn is imported by ``decoders/sklearn_compat.py`` alone
    (the card's machine has none); the decoders package exports its
    classes lazily."""
    port = ROOT / "cross_patient_speech_decoding_tpu_torch"
    users = sorted(str(p.relative_to(port)) for p in port.rglob("*.py")
                   if any(n.split(".")[0] == "sklearn" for n in _imports(p)))
    assert users == ["decoders/sklearn_compat.py"]
    import cross_patient_speech_decoding_tpu_torch.decoders as dec

    assert "sklearn_compat" not in vars(dec)
    assert dec.AlignCCA.__module__.endswith("sklearn_compat")
    with pytest.raises(AttributeError):
        dec.NotAnEstimator  # noqa: B018


@pytest.fixture(scope="module")
def sk_data():
    """Three patients of one channel count (JAX's eager ops compile once
    per shape), labels and the cross patients' (X, y, y_align)."""
    pytest.importorskip("sklearn")
    ds = make_synthetic_patients(seed=0, n_patients=3, n_classes=6,
                                 trials_per_class=8, T=12,
                                 channels=(16, 16, 16), latent_dim=5,
                                 noise=1.0)
    uniq = np.unique(np.concatenate(ds.y_first))
    ys = [np.searchsorted(uniq, y) for y in ds.y_first]
    cross = [(ds.X[i], ys[i], ds.y_seq[i]) for i in (1, 2)]
    return ds, ys, cross


def _close_up_to_sign(got, want):
    s = np.sign((got * want).sum(0))
    s[s == 0] = 1
    np.testing.assert_allclose(got * s, want,
                               atol=TRANSFORM_RTOL * np.abs(want).max())


def test_sklearn_compat_reducers_match_jax(sk_data):
    """NoCenterPCA, JaxPCA and DimRedReshape (with a set_params path):
    transforms against JAX's up to column sign."""
    import cross_patient_speech_decoding_tpu.decoders.sklearn_compat as jsk
    import cross_patient_speech_decoding_tpu_torch.decoders as tdec

    ds, _, _ = sk_data
    X0 = ds.X[0]
    flat = X0.reshape(len(X0), -1)
    for name in ("NoCenterPCA", "JaxPCA"):
        t = getattr(tdec, name)(n_components=5, device="cpu").fit(flat)
        j = getattr(jsk, name)(n_components=5).fit(flat)
        assert t.n_components_ == j.n_components_
        _close_up_to_sign(t.transform(flat), j.transform(flat))
    dr = tdec.DimRedReshape(n_components=6, device="cpu")
    dr.set_params(n_components=4)
    _close_up_to_sign(dr.fit_transform(X0),
                      jsk.DimRedReshape(n_components=4).fit_transform(X0))
    assert set(dr.get_params()) == set(
        jsk.DimRedReshape().get_params()) | {"device"}


def test_sklearn_compat_align_cca_matches_jax(sk_data):
    import cross_patient_speech_decoding_tpu.decoders.sklearn_compat as jsk
    import cross_patient_speech_decoding_tpu_torch.decoders as tdec

    ds, _, _ = sk_data
    a = tdec.AlignCCA(device="cpu").fit(ds.X[0], ds.X[1], ds.y_seq[0],
                                        ds.y_seq[1])
    a_j = jsk.AlignCCA().fit(ds.X[0], ds.X[1], ds.y_seq[0], ds.y_seq[1])
    np.testing.assert_allclose(a.canon_corrs, a_j.canon_corrs, atol=1e-4)
    want = a_j.transform(ds.X[1])
    np.testing.assert_allclose(a.transform(ds.X[1]), want,
                               atol=TRANSFORM_RTOL * np.abs(want).max())


@pytest.mark.parametrize("cls", ["CrossPtDecoderSepAlign",
                                 "CrossPtDecoderSepDimRed",
                                 "CrossPtDecoderJointPCA",
                                 "CrossPtDecoderMCCA"])
def test_sklearn_compat_decoders_match_jax(sk_data, cls):
    """The crossPtDecoder estimators around an SVC: parameter names, test
    features up to the sign of each latent column (1e-3 of the largest),
    and predictions as JAX's where the strategy is invariant to those
    signs (all but sepDimRed, whose common width is compared)."""
    from sklearn.svm import SVC

    import cross_patient_speech_decoding_tpu.decoders.sklearn_compat as jsk
    import cross_patient_speech_decoding_tpu_torch.decoders as tdec

    ds, ys, cross = sk_data
    X0 = ds.X[0]
    kw = {"n_comp": 4} if cls == "CrossPtDecoderMCCA" else {}
    t = getattr(tdec, cls)(cross, SVC(kernel="linear"), device="cpu", **kw)
    j = getattr(jsk, cls)(cross, SVC(kernel="linear"), **kw)
    assert set(t.get_params()) == set(j.get_params()) | {"device"}
    extra = ({} if cls == "CrossPtDecoderSepDimRed"
             else {"y_align": ds.y_seq[0]})
    t.fit(X0, ys[0], **extra)
    j.fit(X0, ys[0], **extra)
    got, want = t.preprocess_test(X0), j.preprocess_test(X0)
    T = X0.shape[1]
    _close_up_to_sign(got.reshape(len(X0) * T, -1),
                      want.reshape(len(X0) * T, -1))
    if cls == "CrossPtDecoderSepDimRed":
        # independent per-patient PCAs: not invariant to their signs
        assert t.common_dim == j.common_dim
    else:
        np.testing.assert_array_equal(t.predict(X0), j.predict(X0))
