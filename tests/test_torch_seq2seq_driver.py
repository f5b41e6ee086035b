"""The port's seq2seq experiment driver (``run_train_seq2seq``, ``cpsd
train-seq2seq``) and fold trainer (``train/fold_parallel.py``) against the
JAX package's, on the CPU at small sizes.

Both drivers get the same data: their synthetic generators are replaced
by the JAX package's host generator (the port's device twin draws from a
``torch.Generator``, JAX's from ``jax.random``), and file-backed runs read
one decoding-data pickle written in ``tmp_path``. Splits are numpy draws
in the same order on both sides. The parity runs train at dropout 0 and
teacher forcing 1 (or 0 for the trainer), where no random draw matters,
from JAX's own initial weights carried over by
``seq2seq_params_from_flax`` (the fold trainer's ``init_states``), with
JAX's PCA signs (:func:`_patch_pca_signs`) and JAX's products at full
float32. Tolerances:

- parameters after training: atol 2e-6 (tests/test_torch_seq2seq.py's
  two-step bound), the conv bias 2 lr per step (its gradient is rounding
  noise on both sides, which Adam turns into steps of about lr);
- per-fold latents relative to their largest value: PCA 2e-4, CCA-mapped
  1e-3 (tests/test_torch_alignment.py's bounds);
- accuracies: equal, except that each test trial whose top two logits
  (at any decoder step) lie within 1e-4 of their magnitude may flip: the
  accuracy may then move by that trial's share of the test tokens.
"""

import csv
import functools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cross_patient_speech_decoding_tpu.models as jmodels
import torch_parallel_ranks as ranks
import cross_patient_speech_decoding_tpu.train as jtrain
from cross_patient_speech_decoding_tpu.cli import experiments as je
from cross_patient_speech_decoding_tpu.data import synthetic as jsyn
from cross_patient_speech_decoding_tpu.decoders import pooled as jpool
from cross_patient_speech_decoding_tpu.ops import augment as jaug
from cross_patient_speech_decoding_tpu.train import fold_parallel as jfp
from cross_patient_speech_decoding_tpu.utils.config import (
    TrainSeq2SeqConfig as JaxCfg,
)
import cross_patient_speech_decoding_tpu_torch.train as ttrain
from cross_patient_speech_decoding_tpu_torch import parallel
from cross_patient_speech_decoding_tpu_torch.cli import experiments as te
from cross_patient_speech_decoding_tpu_torch.cli import main as tmain
from cross_patient_speech_decoding_tpu_torch.data import loaders
from cross_patient_speech_decoding_tpu_torch.models import (
    Seq2SeqRNN,
    seq2seq_params_from_flax,
)
from cross_patient_speech_decoding_tpu_torch.ops import augment
from cross_patient_speech_decoding_tpu_torch.train import fold_parallel as tfp
from cross_patient_speech_decoding_tpu_torch.utils.config import (
    TrainCTCConfig,
    TrainSeq2SeqConfig,
)

torch.set_num_threads(2)

PARAM_ATOL = 2e-6
PCA_RTOL = 2e-4
ALIGNED_RTOL = 1e-3
DECIDED = 1e-4
AUG_ATOL = 1e-6
LR = 1e-3
SMALL = dict(synth_patients=3, synth_T=16, synth_trials=4, n_folds=4,
             n_iter=2, epochs=3, hidden=8, n_filters=4, kernel_size=4,
             lr=LR, decay_iters=10, seed=3)


def _cfgs(tmp_path, **kw):
    kw = {**SMALL, **kw}
    return (JaxCfg(out=str(tmp_path / "j" / "s2s.csv"), **kw),
            TrainSeq2SeqConfig(out=str(tmp_path / "t" / "s2s.csv"), **kw))


@pytest.fixture
def host_synth(monkeypatch):
    """Both drivers' synthetic data from the JAX package's host generator
    (the port's own host generator is bit for bit the same)."""
    monkeypatch.setattr(je, "make_synthetic_patients_device",
                        lambda **kw: jsyn.make_synthetic_patients(**kw))
    monkeypatch.setattr(te, "make_synthetic_patients_device",
                        lambda device=None, **kw:
                        jsyn.make_synthetic_patients(**kw))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _fold(tree, f):
    return jax.tree_util.tree_map(lambda a: a[f], tree)


def _jax_model(cfg_or_kw):
    kw = (cfg_or_kw if isinstance(cfg_or_kw, dict) else
          dict(n_filters=cfg_or_kw.n_filters, hidden=cfg_or_kw.hidden,
               kernel_size=cfg_or_kw.kernel_size))
    return jmodels.Seq2SeqRNN(num_classes=9, cnn_dropout=0.0,
                              rnn_dropout=0.0, **kw)


def _jax_fold_inits(jm, X, y, seed, n_folds, teacher_forcing):
    """The JAX fold trainer's initial weights (fold_parallel.py:117-118) as
    the port's state dicts, one per fold."""
    x_example = X[0] if X.ndim == 4 else X

    def init_one(key):
        v = jm.init({"params": key, "tf": jax.random.key(0)},
                    x_example[:1], y[:1], teacher_forcing)
        return v["params"], v.get("batch_stats", {})

    p, bs = _np(jax.jit(jax.vmap(init_one))(
        jax.random.split(jax.random.key(seed), n_folds)))
    return [seq2seq_params_from_flax(_fold(p, f), _fold(bs, f))
            for f in range(n_folds)]


def _port_model(**kw):
    return functools.partial(Seq2SeqRNN, num_classes=9, cnn_dropout=0.0,
                             rnn_dropout=0.0, **kw)


def _undecided_rows(logits):
    """(N,) rows with a decoder step whose top two logits lie within
    DECIDED of their magnitude."""
    top2 = logits.double().topk(2, dim=-1).values
    close = (top2[..., 0] - top2[..., 1]) <= DECIDED * top2.abs().amax(-1)
    return close.any(-1)


def _slack(model, x, test_mask):
    """The share of the test rows whose prediction may flip."""
    model.eval()
    with torch.no_grad():
        und = _undecided_rows(model(x, None, 0.0))
    rows = test_mask > 0
    return float((und & rows).sum()) / max(1, int(rows.sum()))


def _assert_accs(got, want, slack):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert (np.abs(got - want) <= np.asarray(slack) + 1e-6).all(), (
        got, want, slack)


@pytest.fixture
def eval_slack(monkeypatch):
    """Records, for every fold the port's trainer evaluates, its accuracy
    and the share of its test rows that may flip."""
    rec = []
    orig = tfp._fold_eval

    def ev(model, x, y, test_mask):
        acc = orig(model, x, y, test_mask)
        rec.append(_slack(model, x, test_mask))
        return acc

    monkeypatch.setattr(tfp, "_fold_eval", ev)
    return rec


# --------------------------------------------------------------- config --


def test_config_fields_and_defaults_match_jax():
    import dataclasses

    got = [(f.name, f.default) for f in dataclasses.fields(TrainSeq2SeqConfig)]
    want = [(f.name, f.default) for f in dataclasses.fields(JaxCfg)]
    assert got == want


# ---------------------------------------------------------- fold arrays --


@pytest.mark.parametrize("ndim,explicit", [(3, False), (3, True), (4, False),
                                           (4, True)])
def test_pooled_fold_arrays_match_jax(ndim, explicit):
    """X_pool, y_pool, weights and test masks equal JAX's, with features
    shared by the folds (3-D) or per fold (4-D), the test masks the train
    complement or given (rows in neither set)."""
    rng = np.random.default_rng(ndim)
    lead = (3,) if ndim == 4 else ()
    tar = rng.normal(size=lead + (6, 5, 2)).astype(np.float32)
    cross = [rng.normal(size=lead + (n, 5, 2)).astype(np.float32)
             for n in (4, 3)]
    ys = [rng.integers(0, 9, size=(n, 3)) for n in (6, 4, 3)]
    tr = (rng.random((3, 6)) < 0.6).astype(np.float64)
    tm = (1.0 - tr) * (rng.random((3, 6)) < 0.5) if explicit else None
    got = tfp.pooled_fold_arrays(torch.from_numpy(tar), ys[0],
                                 [torch.from_numpy(c) for c in cross], ys[1:],
                                 tr, test_masks=tm)
    want = jfp.pooled_fold_arrays(jnp.asarray(tar), jnp.asarray(ys[0]),
                                  [jnp.asarray(c) for c in cross],
                                  [jnp.asarray(y) for y in ys[1:]], tr,
                                  test_masks=tm)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2].dtype == got[3].dtype == torch.float32


# --------------------------------------------------------- augmentation --


def _jax_draws(name, key, x):
    """The random numbers the JAX transform draws from ``key``
    (ops/augment.py:23-72)."""
    N, T = x.shape[:2]
    if name == "time_warping":
        return jax.random.uniform(jaug.x_key(key, 0), (N,), minval=0.8,
                                  maxval=1.2)
    if name == "time_masking":
        k1, k2 = jax.random.split(key)
        return (jax.random.randint(k1, (N,), 0, 11),
                jax.random.randint(k2, (N,), 0, max(T - 10, 1)))
    if name == "time_shifting":
        return jax.random.randint(key, (N,), -10, 11)
    if name == "noise_jitter":
        return jax.random.normal(key, x.shape, jnp.float32)
    return jax.random.normal(key, (N, 1, 1), jnp.float32)


def test_augment_stack_folds_applies_jax_draws(monkeypatch):
    """The port's per-fold stack of augmented copies, its draws replaced by
    those JAX's ``_augment_stack_folds`` takes from its key, equals JAX's:
    copies on the trial axis, each fold's rows drawn independently."""
    names = te._CTC_AUGS
    x = np.random.default_rng(0).normal(size=(3, 5, 24, 2)).astype(
        np.float32)
    flat = x.reshape(15, 24, 2)
    key = jax.random.key(9)
    want = np.asarray(je._augment_stack_folds(jnp.asarray(x), names, key))
    draws = []
    for name in names:
        key, sub = jax.random.split(key)
        d = _jax_draws(name, sub, flat)
        draws.append(tuple(torch.from_numpy(np.array(a)) for a in d)
                     if isinstance(d, tuple) else torch.from_numpy(
                         np.array(d)))
    it = iter(draws)
    for name in names:
        monkeypatch.setattr(augment, f"{name}_draw",
                            lambda gen, x, *a, **k: next(it))
    got = te._augment_stack_folds(torch.from_numpy(x), names,
                                  torch.Generator().manual_seed(0))
    assert got.shape == want.shape == (3, 30, 24, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=AUG_ATOL, rtol=0)


def _stub_trainers(monkeypatch):
    """Both drivers' fold trainers replaced by stubs that train nothing;
    returns what each driver's ``pooled_fold_arrays`` gave."""
    seen = {"jax": [], "port": []}
    orig_j, orig_t = jfp.pooled_fold_arrays, tfp.pooled_fold_arrays

    def rec(store, fn):
        def pooled(*a, **k):
            out = fn(*a, **k)
            store.append(out)
            return out
        return pooled

    monkeypatch.setattr(jfp, "pooled_fold_arrays", rec(seen["jax"], orig_j))
    monkeypatch.setattr(tfp, "pooled_fold_arrays", rec(seen["port"], orig_t))
    monkeypatch.setattr(
        jfp, "make_seq2seq_fold_trainer_fn",
        lambda *a, **k: lambda X, y, w, te_, s, e: (jnp.zeros(w.shape[0]),
                                                    None))
    monkeypatch.setattr(
        tfp, "make_seq2seq_fold_trainer_fn",
        lambda *a, **k: lambda X, y, w, te_, s, e: (torch.zeros(w.shape[0]),
                                                    []))
    return seen


def test_augmented_fold_masks_match_jax(tmp_path, host_synth, monkeypatch):
    """With the reference's post-alignment augmentations, the pooled
    weights and test masks of both drivers are equal: the train masks
    tile over the augmented copies, the copies of test rows are in neither
    set; the pooled features have the same shape."""
    seen = _stub_trainers(monkeypatch)
    kw = dict(n_iter=1, augmentations="time_shifting,noise_jitter,scaling",
              log_metrics=False)
    cfg_j, cfg = _cfgs(tmp_path, **kw)
    je.run_train_seq2seq(cfg_j, verbose=False)
    te.run_train_seq2seq(cfg, verbose=False, device="cpu")
    (Xj, yj, wj, tej), = seen["jax"]
    (X, y, w, te_), = seen["port"]
    assert X.shape == Xj.shape == (4, 4 * (36 + 36 + 36), 16, 24)
    np.testing.assert_array_equal(y.numpy(), np.asarray(yj))
    np.testing.assert_array_equal(w.numpy(), np.asarray(wj))
    np.testing.assert_array_equal(te_.numpy(), np.asarray(tej))
    # 36 target rows: 9 test rows a fold, none of their copies
    assert te_.sum(1).tolist() == [9.0] * 4
    assert w[:, : 4 * 36].sum(1).tolist() == [4 * 27.0] * 4


# --------------------------------------------------------- fold trainer --


@pytest.mark.parametrize("teacher_forcing", [0.0, 1.0])
def test_fold_trainer_matches_jax(teacher_forcing, eval_slack):
    """Three folds of three epochs from JAX's per-fold initial weights, at
    dropout 0: every parameter of every fold within PARAM_ATOL of JAX's
    (the conv bias within 2 lr a step), and the fold accuracies equal up
    to the test rows that may flip. The target's held-out rows (weight 0)
    enter the BatchNorm's batch statistics on both sides."""
    n_folds, epochs = 3, 3
    rng = np.random.default_rng(0)
    tar = rng.normal(size=(n_folds, 12, 16, 5)).astype(np.float32)
    cross = rng.normal(size=(n_folds, 10, 16, 5)).astype(np.float32)
    yt, yc = (rng.integers(0, 9, size=(n, 3)) for n in (12, 10))
    tr = (rng.random((n_folds, 12)) < 0.7).astype(np.float64)
    widths = dict(n_filters=6, hidden=12, kernel_size=4)
    jm = _jax_model(widths)
    args_j = jfp.pooled_fold_arrays(jnp.asarray(tar), jnp.asarray(yt),
                                    [jnp.asarray(cross)], [jnp.asarray(yc)],
                                    tr)
    fn_j = jfp.make_seq2seq_fold_trainer_fn(
        jm, lr=LR, decay_iters=10, teacher_forcing=teacher_forcing)
    with jax.default_matmul_precision("highest"):
        accs_j, params_j = fn_j(*args_j, 5, epochs)
    params_j = _np(params_j)
    inits = _jax_fold_inits(jm, args_j[0], args_j[1], 5, n_folds,
                            teacher_forcing)
    fn = tfp.make_seq2seq_fold_trainer_fn(
        _port_model(**widths), lr=LR, decay_iters=10,
        teacher_forcing=teacher_forcing)
    args = tfp.pooled_fold_arrays(torch.from_numpy(tar), yt,
                                  [torch.from_numpy(cross)], [yc], tr)
    accs, models = fn(*args, 5, epochs, init_states=inits)
    for f in range(n_folds):
        want = seq2seq_params_from_flax(_fold(params_j, f), {})
        got = models[f].state_dict()
        for name, w in want.items():
            atol = 2 * LR * epochs if name == "conv.bias" else PARAM_ATOL
            np.testing.assert_allclose(got[name].numpy(), w.numpy(),
                                       atol=atol, err_msg=f"fold {f} {name}")
    _assert_accs(accs.numpy(), accs_j, eval_slack)


def test_fold_trainer_seeds_shared_features_and_options():
    """Without ``init_states`` fold f starts from ``Seq2SeqRNN(seed=seed +
    f)``; X shared by the folds (3-D) trains as the same X given per fold
    (4-D); both ``rnn_impl`` values run the same code, any other raises,
    as does 'pallas' with a mesh (JAX's refusal);
    ``make_seq2seq_fold_trainer`` closes over the arrays. With a mesh of
    two gloo ranks (``torch_parallel_ranks.fold_trainer_checks``) each
    rank trains one of the 2 folds and the accuracies are the one-device
    trainer's bit for bit; 3 folds do not divide the ranks: a warning, and
    every rank trains all three."""
    rng = np.random.default_rng(1)
    X = torch.from_numpy(rng.normal(size=(10, 12, 3)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 9, size=(10, 3)))
    tr = (rng.random((2, 10)) < 0.7).astype(np.float64)
    _, _, w, tm = tfp.pooled_fold_arrays(X, y, [], [], tr)
    model = functools.partial(Seq2SeqRNN, n_filters=4, hidden=6,
                              num_classes=9, kernel_size=3)
    fn = tfp.make_seq2seq_fold_trainer_fn(model, teacher_forcing=0.5)
    accs, models = fn(X, y, w, tm, 7, 0)
    assert accs.shape == (2,)
    for f, m in enumerate(models):
        fresh = model(3, seed=7 + f, device="cpu").state_dict()
        for k, v in m.state_dict().items():
            assert torch.equal(v, fresh[k]), k
    a3, m3 = fn(X, y, w, tm, 7, 2)
    a4, m4 = fn(X.expand(2, *X.shape), y, w, tm, 7, 2)
    torch.testing.assert_close(a3, a4, rtol=0, atol=0)
    for p, q in zip(m3, m4):
        for k, v in p.state_dict().items():
            torch.testing.assert_close(v, q.state_dict()[k], rtol=0, atol=0)
    pal = tfp.make_seq2seq_fold_trainer_fn(model, teacher_forcing=0.5,
                                           rnn_impl="pallas")
    torch.testing.assert_close(pal(X, y, w, tm, 7, 2)[0], a3, rtol=0, atol=0)
    closed = tfp.make_seq2seq_fold_trainer(model, X, y, w, tm, seed=7)
    torch.testing.assert_close(closed(2)[0], a3, rtol=0, atol=0)
    with pytest.raises(ValueError, match="rnn_impl"):
        tfp.make_seq2seq_fold_trainer_fn(model, rnn_impl="cudnn")
    one = parallel.make_mesh(1, device="cpu")
    with pytest.raises(ValueError, match="pallas"):
        tfp.make_seq2seq_fold_trainer_fn(model, mesh=one, rnn_impl="pallas")
    tr3 = (rng.random((3, 10)) < 0.7).astype(np.float64)
    _, _, w3, tm3 = tfp.pooled_fold_arrays(X, y, [], [], tr3)
    spec = dict(model=dict(n_filters=4, hidden=6, num_classes=9,
                           kernel_size=3),
                arrays=[a.numpy() for a in (X, y, w, tm)],
                arrays_odd=[a.numpy() for a in (X, y, w3, tm3)], seed=7,
                epochs=2)
    got = parallel.launch(ranks.fold_trainer_checks, 2, (spec,),
                          devices="cpu", timeout=120)
    with ranks.threads(1):
        a2 = fn(X, y, w, tm, 7, 2)[0].numpy()
        a3odd = fn(X, y, w3, tm3, 7, 2)[0].numpy()
    np.testing.assert_array_equal(got["arrays"]["accs"], a2)
    assert got["arrays"]["n_local"] == 1 and not got["arrays"]["warned"]
    np.testing.assert_array_equal(got["arrays_odd"]["accs"], a3odd)
    assert got["arrays_odd"]["n_local"] == 3
    assert any("UNSHARDED" in m for m in got["arrays_odd"]["warned"])


def test_rnn_impl_values_on_the_driver(tmp_path, host_synth):
    """rnn_impl='pallas' gives the 'scan' run's accuracies (one GRU route
    per device in the port); an unknown value raises as in JAX."""
    kw = dict(n_iter=1, epochs=2, log_metrics=False)
    a = te.run_train_seq2seq(TrainSeq2SeqConfig(
        out=str(tmp_path / "a.csv"), **{**SMALL, **kw}), False, "cpu")
    b = te.run_train_seq2seq(TrainSeq2SeqConfig(
        out=str(tmp_path / "b.csv"), rnn_impl="pallas", **{**SMALL, **kw}),
        False, "cpu")
    np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="rnn_impl"):
        te.run_train_seq2seq(TrainSeq2SeqConfig(
            out=str(tmp_path / "c.csv"), rnn_impl="xla", **{**SMALL, **kw}),
            False, "cpu")


# ------------------------------------------------------------- drivers --


def _jax_pca_one(X, mask, max_k):
    st = jpool._fit_pca_latents(X, 0.9, max_k, sample_mask=mask)
    return jpool._transform_latents(st, X, max_k)


_jax_pca = jax.jit(_jax_pca_one, static_argnums=2)
_jax_pca_folds = jax.jit(jax.vmap(_jax_pca_one, in_axes=(None, 0, None)),
                         static_argnums=2)


def _patch_pca_signs(monkeypatch):
    """A principal component's sign is free, and the packages' solvers pick
    it differently (JAX's vmapped and unvmapped fits differ too). The
    port's PCA latents take JAX's sign for each column from JAX's fit of
    the same rows, as the JAX driver makes it (jit of a vmap over the
    folds' masks, or of one fold's), so both runs train on the same
    features."""
    orig = te._seq2seq_pca

    def pca(X, mask, max_k):
        lat = orig(X, mask, max_k)
        fit = _jax_pca_folds if mask is not None and mask.dim() == 2 \
            else _jax_pca
        lat_j = np.array(fit(
            jnp.asarray(X.numpy()),
            None if mask is None else jnp.asarray(mask.numpy()), max_k))
        dots = (lat * torch.from_numpy(lat_j)).sum((-3, -2), keepdim=True)
        return lat * torch.where(dots < 0, -1.0, 1.0)

    monkeypatch.setattr(te, "_seq2seq_pca", pca)


@pytest.fixture
def parity(monkeypatch, host_synth):
    """Both drivers at dropout 0 and teacher forcing 1, the port from JAX's
    initial weights and PCA signs; records the pooled arrays each driver
    built, and for the port each evaluation's share of rows that may
    flip."""
    rec = {"jax": [], "port": [], "slack": []}
    jm_cls = jmodels.Seq2SeqRNN
    monkeypatch.setattr(jmodels, "Seq2SeqRNN", functools.partial(
        jm_cls, cnn_dropout=0.0, rnn_dropout=0.0))
    monkeypatch.setattr(jtrain, "make_seq2seq_train_step", functools.partial(
        jtrain.make_seq2seq_train_step, teacher_forcing=1.0))
    monkeypatch.setattr(ttrain, "make_seq2seq_train_step", functools.partial(
        ttrain.make_seq2seq_train_step, teacher_forcing=1.0))
    _patch_pca_signs(monkeypatch)

    orig_pool_j, orig_pool_t = jfp.pooled_fold_arrays, tfp.pooled_fold_arrays

    def pool_j(*a, **k):
        rec["jax"].append((a[0], a[2]))
        return orig_pool_j(*a, **k)

    def pool_t(*a, **k):
        rec["port"].append((a[0], a[2]))
        return orig_pool_t(*a, **k)

    monkeypatch.setattr(jfp, "pooled_fold_arrays", pool_j)
    monkeypatch.setattr(tfp, "pooled_fold_arrays", pool_t)
    orig_fn_j, orig_fn_t = (jfp.make_seq2seq_fold_trainer_fn,
                            tfp.make_seq2seq_fold_trainer_fn)
    monkeypatch.setattr(jfp, "make_seq2seq_fold_trainer_fn",
                        lambda m, **k: orig_fn_j(m, teacher_forcing=1.0, **k))

    def fn_t(model, **k):
        fn = orig_fn_t(model, teacher_forcing=1.0, **k)

        def train(X, y, w, tm, seed, epochs):
            jm = _jax_model(rec["cfg"])
            inits = _jax_fold_inits(jm, jnp.asarray(X.numpy()),
                                    jnp.asarray(y.numpy()), seed,
                                    w.shape[0], 1.0)
            return fn(X, y, w, tm, seed, epochs, init_states=inits)
        return train

    monkeypatch.setattr(tfp, "make_seq2seq_fold_trainer_fn", fn_t)
    monkeypatch.setattr(te, "_seq2seq_model", lambda cfg: _port_model(
        n_filters=cfg.n_filters, hidden=cfg.hidden,
        kernel_size=cfg.kernel_size))

    orig_ev = ttrain.make_seq2seq_eval_step

    def ev_t(model):
        step = orig_ev(model)

        def run(batch):
            out = step(batch)
            rec["slack"].append(_slack(model, batch[0],
                                       torch.ones(len(batch[0]))))
            return out
        return run

    monkeypatch.setattr(ttrain, "make_seq2seq_eval_step", ev_t)
    return rec


def _patch_sequential_init(monkeypatch):
    """The sequential path's fold k starts from JAX's
    ``model.init(jax.random.key(seed + k))``
    (cli/experiments.py:787-789)."""

    def model_t(cfg):
        jm = _jax_model(cfg)
        init = jax.jit(lambda key, x: jm.init(
            {"params": key, "tf": jax.random.key(1)}, x,
            jnp.zeros((1, 3), jnp.int32), 0.5))

        def make(C, seed, device):
            m = _port_model(n_filters=cfg.n_filters, hidden=cfg.hidden,
                            kernel_size=cfg.kernel_size)(C, seed=seed,
                                                         device=device)
            v = _np(init(jax.random.key(seed),
                         jnp.zeros((1, cfg.synth_T, C))))
            m.load_state_dict(seq2seq_params_from_flax(v["params"],
                                                       v["batch_stats"]))
            return m
        return make

    monkeypatch.setattr(te, "_seq2seq_model", model_t)


def _run_both(tmp_path, parity, eval_slack=None, **kw):
    cfg_j, cfg = _cfgs(tmp_path, **kw)
    parity["cfg"] = cfg
    with jax.default_matmul_precision("highest"):
        accs_j = je.run_train_seq2seq(cfg_j, verbose=False)
    accs = te.run_train_seq2seq(cfg, verbose=False, device="cpu")
    return cfg_j, cfg, accs_j, accs


def _check_features(parity, n_cross):
    assert len(parity["port"]) == len(parity["jax"]) > 0
    for (tar, cross), (tar_j, cross_j) in zip(parity["port"],
                                              parity["jax"]):
        assert len(cross) == len(cross_j) == n_cross
        pairs = [(tar, tar_j, PCA_RTOL)] + [(c, cj, ALIGNED_RTOL)
                                            for c, cj in zip(cross, cross_j)]
        for got, want, rtol in pairs:
            want = np.asarray(want)
            got = got.numpy()
            if got.ndim == 3 and want.ndim == 4:  # raw channels, shared
                got = np.broadcast_to(got, want.shape)
            assert got.shape == want.shape
            err = np.abs(got - want).max()
            assert err <= rtol * np.abs(want).max(), err


def test_fold_parallel_driver_matches_jax(tmp_path, parity, eval_slack,
                                          capsys):
    """Two iterations of four folds, aligned pooling of three patients: the
    leak-free per-fold features (target PCA on each fold's train rows,
    each source's CCA fit batched over the folds) equal to JAX's
    ``fold_feats_batched``, every fold's accuracy equal to JAX's, the
    results CSV and progress pickle as JAX's. A results store written by
    the JAX driver resumes in the port with no work left."""
    cfg_j, cfg, accs_j, accs = _run_both(tmp_path, parity, eval_slack)
    _check_features(parity, n_cross=2)
    assert accs.shape == accs_j.shape == (8,)
    _assert_accs(accs, accs_j, eval_slack)
    np.testing.assert_allclose(np.loadtxt(cfg.out, delimiter=","), accs)
    store = loaders.load_pkl(cfg.out.replace(".csv", ".progress.pkl"))
    assert len(store["accs"]) == 2
    assert store["params"] == {**vars(cfg_j), "out": cfg.out}

    cfg.out = cfg_j.out
    again = te.run_train_seq2seq(cfg, verbose=True, device="cpu")
    assert "resuming: 2/2 iterations done" in capsys.readouterr().out
    np.testing.assert_array_equal(again, accs_j)


def test_pt_specific_matches_jax(tmp_path, parity, eval_slack):
    """One patient: no dimension reduction, the raw channels trained by
    every fold (JAX broadcasts them over the folds, the port shares one
    array)."""
    _, _, accs_j, accs = _run_both(tmp_path, parity, synth_patients=1,
                                   n_iter=1)
    _check_features(parity, n_cross=0)
    _assert_accs(accs, accs_j, eval_slack)


def test_sequential_driver_matches_jax(tmp_path, parity, monkeypatch):
    """fold_parallel=false: per fold a ``fit`` from JAX's
    ``model.init(key(seed + k))``, validation every epoch, the best test
    accuracy kept, equal to JAX's up to the rows that may flip in any of
    the fold's evaluations; the per-epoch validation losses as JAX's
    within 1e-4 relative."""
    _patch_sequential_init(monkeypatch)
    cfg_j, cfg, accs_j, accs = _run_both(tmp_path, parity, n_iter=1,
                                         fold_parallel=False)
    slack = np.asarray(parity["slack"]).reshape(4, 3).max(1)
    _assert_accs(accs, accs_j, slack)
    for k in range(4):
        rows = []
        for c in (cfg, cfg_j):
            path = (tmp_path / ("t" if c is cfg else "j") / "logs"
                    / "S14_aligned_seq2seq" / f"iter000_fold{k:02d}.csv")
            with open(path) as f:
                rows.append(list(csv.DictReader(f)))
        assert [r["epoch"] for r in rows[0]] == [r["epoch"] for r in rows[1]]
        for r, rj in zip(*rows):
            np.testing.assert_allclose(float(r["loss"]), float(rj["loss"]),
                                       rtol=1e-4)


def _decoding_dict(seed=0):
    """A ``pt_decoding_data`` dict in the reference's layout: three
    patients, phoneme position 1 arrays and full sequences of 3."""
    ds = jsyn.make_synthetic_patients(seed=seed, n_patients=3, n_classes=9,
                                      trials_per_class=4, T=16,
                                      channels=(20, 24, 18), latent_dim=5,
                                      noise=0.5)
    names = ["S14", "S26", "S33"]
    return {name: {"X1": ds.X[p].astype(np.float32),
                   "y1": ds.y_seq[p][:, 0], "y_full_phon": ds.y_seq[p],
                   "pre_pts": [m for m in names if m != name]}
            for p, name in enumerate(names)}


def test_pickle_data_path_matches_jax(tmp_path, parity, eval_slack):
    """data=<pt_decoding_data.pkl>: p_ind=1 arrays, the full phoneme
    sequences as targets, the pre_pts pooled; both drivers read the same
    file and agree."""
    d = _decoding_dict()
    path = tmp_path / "pt_decoding_data.pkl"
    with open(path, "wb") as f:
        pickle.dump(d, f)
    Xs, ys = te._seq2seq_arrays(TrainSeq2SeqConfig(data=str(path)), "cpu")
    assert [tuple(x.shape) for x in Xs] == [(36, 16, c) for c in (20, 24, 18)]
    np.testing.assert_array_equal(ys[1], d["S26"]["y_full_phon"])
    _, _, accs_j, accs = _run_both(tmp_path, parity, data=str(path),
                                   n_iter=1)
    _check_features(parity, n_cross=2)
    _assert_accs(accs, accs_j, eval_slack)


# ------------------------------------------------------- port behaviour --


def _run(tmp_path, name="s2s", verbose=False, **kw):
    cfg = TrainSeq2SeqConfig(out=str(tmp_path / name / "s2s.csv"),
                             **{**SMALL, **kw})
    return cfg, te.run_train_seq2seq(cfg, verbose=verbose, device="cpu")


def test_fold_chunk_seeds_each_chunk(tmp_path, host_synth, monkeypatch):
    """fold_chunk=2 trains two chunks of two folds, the chunk at fold c0
    seeded seed + it + 31 c0: the first chunk's folds are the unchunked
    run's first two."""
    calls = []
    orig = tfp.make_seq2seq_fold_trainer_fn

    def fn(*a, **k):
        train = orig(*a, **k)

        def run(X, y, w, tm, seed, epochs):
            calls.append((X.shape[0], w.shape[0], seed))
            return train(X, y, w, tm, seed, epochs)
        return run

    monkeypatch.setattr(tfp, "make_seq2seq_fold_trainer_fn", fn)
    _, full = _run(tmp_path, "full", n_iter=1)
    _, chunked = _run(tmp_path, "chunk", n_iter=1, fold_chunk=2)
    s = SMALL["seed"]
    assert calls == [(4, 4, s), (2, 2, s), (2, 2, s + 62)]
    np.testing.assert_array_equal(chunked[:2], full[:2])
    assert chunked.shape == (4,)


def test_resume_and_fold_accs_log(tmp_path, host_synth, monkeypatch,
                                  capsys):
    """A run stopped after one iteration and resumed equals the
    uninterrupted run, and a rerun with nothing left trains nothing; the
    fold_accs.csv log gets one row an iteration, is kept by a resume and
    reset by a fresh run of another config (whose progress store is set
    aside)."""
    _, full = _run(tmp_path, "full")
    cfg, part = _run(tmp_path, "part", n_iter=1)
    log = tmp_path / "part" / "logs" / "S14_aligned_seq2seq" / "fold_accs.csv"

    def rows():
        with open(log) as f:
            return list(csv.DictReader(f))

    assert [r["iter"] for r in rows()] == ["0"]
    _, resumed = _run(tmp_path, "part", verbose=True)
    assert "resuming: 1/2 iterations done" in capsys.readouterr().out
    np.testing.assert_array_equal(resumed, full)
    assert [r["iter"] for r in rows()] == ["0", "1"]
    np.testing.assert_allclose([float(rows()[1][f"fold{j}"]) for j in
                                range(4)], full[4:], rtol=1e-6)

    def boom(*a, **k):
        raise AssertionError("no iteration may run on resume")

    with monkeypatch.context() as m:
        m.setattr(te, "_seq2seq_prep", boom)
        again = _run(tmp_path, "part", verbose=True)[1]
    assert "resuming: 2/2 iterations done" in capsys.readouterr().out
    np.testing.assert_array_equal(again, full)

    _, other = _run(tmp_path, "part", n_iter=1, seed=4)
    assert "config mismatch" in capsys.readouterr().out
    assert [r["iter"] for r in rows()] == ["0"]
    assert float(rows()[0]["fold0"]) == pytest.approx(float(other[0]))
    assert len(list((tmp_path / "part" / "_stale").iterdir())) == 1


def test_cli_train_seq2seq_runs_in_process(tmp_path, host_synth, capsys):
    """``cli.main train-seq2seq device=cpu`` runs the driver with key=value
    overrides; a rerun with the same out resumes; device= is not a config
    field."""
    out = tmp_path / "x" / "s2s.csv"
    args = ["train-seq2seq", "device=cpu", "synth_patients=3", "synth_T=16",
            "synth_trials=4", "n_iter=2", "n_folds=4", "epochs=2",
            "hidden=8", "n_filters=4", f"out={out}"]
    assert tmain.main(args) == 0
    assert "iter 1: 4 folds, mean test acc" in capsys.readouterr().out
    assert np.loadtxt(out, delimiter=",").shape == (8,)
    store = loaders.load_pkl(tmp_path / "x" / "s2s.progress.pkl")
    assert "device" not in store["params"]
    assert tmain.main(args) == 0
    assert "resuming: 2/2 iterations done" in capsys.readouterr().out


def test_prewarm_seq2seq_on_the_cpu(tmp_path, host_synth, monkeypatch,
                                    capsys):
    """prewarm-seq2seq runs one epoch of the first fold chunk (the
    sequential prewarm: one fold) and writes nothing."""
    monkeypatch.chdir(tmp_path)
    epochs = []
    orig = tfp._fold_epoch
    monkeypatch.setattr(tfp, "_fold_epoch",
                        lambda *a: epochs.append(1) or orig(*a))
    small = ["synth_patients=3", "synth_T=16", "synth_trials=4", "hidden=8",
             "n_filters=4", "fold_chunk=2", "n_iter=5", "epochs=7"]
    assert tmain.main(["prewarm-seq2seq", "device=cpu", *small]) == 0
    assert "seq2seq libraries built" in capsys.readouterr().out
    assert len(epochs) == 2  # the first chunk's two folds, one epoch each
    fits = []
    monkeypatch.setattr(ttrain, "make_seq2seq_train_step",
                        _counting(ttrain.make_seq2seq_train_step, fits))
    assert te.run_prewarm_seq2seq(
        TrainSeq2SeqConfig(**{**SMALL, "fold_parallel": False}),
        verbose=False, device="cpu").shape == (0,)
    assert len(fits) == 1
    assert list(tmp_path.iterdir()) == []


def test_prewarm_ctc_on_the_cpu(tmp_path, monkeypatch, capsys):
    """prewarm-ctc builds the native beam library, trains one epoch of one
    iteration and writes nothing."""
    monkeypatch.chdir(tmp_path)
    try:
        assert tmain.main(["prewarm-ctc", "device=cpu", "hidden=8",
                           "n_layers=2", "synth_T=40", "synth_trials=54",
                           "win_size=6", "stride=2", "context=patient",
                           "n_iter=3", "epochs=4",
                           f"results_h5={tmp_path / 'r.h5'}"]) == 0
    finally:
        te._SYNTH_CTC_CACHE.clear()
    assert "ctc libraries built" in capsys.readouterr().out
    assert list(tmp_path.iterdir()) == []


def _counting(make, store):
    def wrapped(*a, **k):
        store.append(1)
        return make(*a, **k)
    return wrapped


def test_unported_options_raise(tmp_path):
    """n_devices without fold_parallel raises JAX's ValueError first and
    writes nothing; n_devices=2 trains every iteration's folds sharded
    over two gloo ranks that the driver launches, and rank 0 alone writes
    the CSV of the 2 x 4 fold accuracies. The TensorBoard log (ported)
    runs: sequential folds write a run directory each."""
    with pytest.raises(ValueError, match="requires fold_parallel"):
        _run(tmp_path, n_devices=2, fold_parallel=False)
    with pytest.raises(ValueError, match="requires fold_parallel"):
        je.run_train_seq2seq(JaxCfg(n_devices=2, fold_parallel=False,
                                    out=str(tmp_path / "j.csv")))
    assert not list(tmp_path.iterdir())
    mcfg, accs = _run(tmp_path, name="mesh", n_devices=2)
    assert accs.shape == (SMALL["n_iter"] * SMALL["n_folds"],)
    assert ((accs >= 0) & (accs <= 1)).all()
    np.testing.assert_array_equal(np.loadtxt(mcfg.out, delimiter=","), accs)
    cfg, _ = _run(tmp_path, log_format="tb", fold_parallel=False, n_iter=1)
    logs = tmp_path / "s2s" / "logs" / te._seq2seq_run_name(cfg)
    for k in range(cfg.n_folds):
        (ev,) = (logs / f"iter000_fold{k:02d}").glob("events.out.tfevents.*")
        assert b"acc" in ev.read_bytes()


def test_seq2seq_entry_points_default_to_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TrainSeq2SeqConfig(out=str(tmp_path / "x.csv"))
    for run in (te.run_train_seq2seq, te.run_prewarm_seq2seq):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        te.run_prewarm_ctc(TrainCTCConfig(out=""))
    assert not list(tmp_path.iterdir())
