"""The port's CTC bucket trainers (``sweep/ctc.py``) against the JAX
package's, on the CPU at small sizes.

Both trainers get the same numpy data and start from the JAX trainer's own
initial weights (``jax.vmap`` of ``model.init`` over
``jax.random.split(jax.random.key(seed), n)``, carried across through
``init_params=`` and ``realtime_rnn_params_from_flax``), at dropout 0.
Final weights are read where each trainer syncs after its last epoch
segment (JAX ``sweep.ctc._sync_tiny`` gets the stacked parameters, the
port's gets each model in turn).

Two JAX paths are held: the CV trainer at ``model_chunk=1`` runs JAX's
Pallas GRU kernels (forced on and run in interpret mode, as
tests/test_torch_ctc_train.py does), which round the layer-0 frames to
bf16 as the port does on every device; the plain trainer and the CV
trainer at ``model_chunk=0`` run JAX's XLA scan GRU on unrounded frames.
One forward of the two paths differs within the bf16-frame tolerance of
tests/test_torch_realtime_rnn.py's ``scan_path_to_bf16_tolerance``, but
Adam makes every update ~lr in size whatever the gradient's, so after a
few steps that rounding moves single weights by ~0.1. The scan-path
comparisons therefore take frames already rounded to bf16, where the
port's rounding is the identity and both paths see the same inputs. Both
paths are then held to float32 roundoff grown over the training steps
(atol 5e-5 on every weight), and the validation PERs (decodes with
symbols after 40 epochs) are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cross_patient_speech_decoding_tpu.ops.pallas_gru as pg
from cross_patient_speech_decoding_tpu.models import RealtimeRNN as JaxRNN
from cross_patient_speech_decoding_tpu.sweep import ctc as jctc
from cross_patient_speech_decoding_tpu_torch.models import (
    realtime_rnn_params_from_flax,
)
from cross_patient_speech_decoding_tpu_torch.sweep import ctc

torch.set_num_threads(2)

N, T, C, L, V = 18, 30, 3, 3, 11
WIN, STRIDE = 6, 2
ARCH = dict(hidden=8, n_layers=2, dropout=0.0)
CFGS = [dict(lr=5e-2, weight_decay=1e-4, **ARCH),
        dict(lr=2e-2, weight_decay=1e-3, **ARCH)]
EPOCHS = 40
SEED = 3
# every final weight against JAX's: float32 roundoff over 40 Adam steps
WEIGHT_ATOL = 5e-5


def _data(seed=0, folds=2, per_fold=False, bf16=False):
    rng = np.random.default_rng(seed)
    shape = (folds, N, T, C) if per_fold else (N, T, C)
    x = rng.normal(size=shape).astype(np.float32)
    if bf16:  # the frames the port's GRU (and JAX's kernels) read
        x = torch.from_numpy(x).bfloat16().float().numpy()
    y = rng.integers(1, V, size=(N, L)).astype(np.int32)
    il = rng.integers(T - 6, T + 1, size=N).astype(np.int32)
    ll = rng.integers(1, L + 1, size=N).astype(np.int32)
    tr = np.ones((folds, N))
    for f in range(folds):
        tr[f, f::folds] = 0.0
    tr[:, -4:] = 1.0  # rows that train in every fold (cross patients)
    return (x, y, il, ll), tr, 1.0 - tr


def _jax_init(n, x_one):
    model = JaxRNN(hidden=ARCH["hidden"], n_layers=ARCH["n_layers"],
                   n_classes=V, dropout=0.0, win_size=WIN, stride=STRIDE)
    keys = jax.random.split(jax.random.key(SEED), n)
    params = jax.vmap(
        lambda k: model.init({"params": k}, jnp.asarray(x_one[:1]))["params"]
    )(keys)
    params = jax.tree_util.tree_map(np.asarray, params)
    return [realtime_rnn_params_from_flax(
        jax.tree_util.tree_map(lambda a: a[i], params)) for i in range(n)]


def _record(monkeypatch):
    """Final weights of both trainers: JAX's stacked parameters at its last
    segment sync, the port's models at theirs."""
    got = {"jax": None, "port": []}
    j_sync, t_sync = jctc._sync_tiny, ctc._sync_tiny

    def jsync(tree):
        got["jax"] = jax.tree_util.tree_map(np.asarray, tree)
        return j_sync(tree)

    def tsync(model):
        got["port"].append({k: v.detach().clone()
                            for k, v in model.state_dict().items()})
        return t_sync(model)

    monkeypatch.setattr(jctc, "_sync_tiny", jsync)
    monkeypatch.setattr(ctc, "_sync_tiny", tsync)
    return got


def _check_weights(got, n):
    assert len(got["port"]) == n
    for i in range(n):
        want = realtime_rnn_params_from_flax(
            jax.tree_util.tree_map(lambda a: a[i], got["jax"]))
        for k, v in want.items():
            np.testing.assert_allclose(got["port"][i][k].numpy(), v.numpy(),
                                       atol=WEIGHT_ATOL, rtol=0,
                                       err_msg=f"model {i} {k}")


@pytest.mark.parametrize("per_fold", [False, True])
@pytest.mark.parametrize("model_chunk", [1, 0])
def test_cv_bucket_trainer_matches_jax(per_fold, model_chunk, monkeypatch):
    """The CV trainer, shared and per-fold x, against JAX's Pallas path
    (model_chunk=1) and its scan path (model_chunk=0, on bf16-rounded
    frames): fold-mean validation PER per trial equal, every model's final
    weights within WEIGHT_ATOL."""
    batch, tr, va = _data(per_fold=per_fold, bf16=model_chunk == 0)
    if model_chunk == 1:
        monkeypatch.setattr(pg, "enabled", lambda: pg._ENABLED)
        monkeypatch.setattr(pg, "worthwhile", lambda B, T: True)
    got = _record(monkeypatch)
    jb = tuple(jnp.asarray(a) for a in batch)
    want = jctc.make_ctc_cv_bucket_trainer(
        jb, tr, va, n_classes=V, win_size=WIN, stride=STRIDE, seed=SEED,
        model_chunk=model_chunk)(CFGS, EPOCHS)
    x_one = batch[0][0] if per_fold else batch[0]
    init = _jax_init(len(CFGS) * 2, x_one)
    tb = (torch.from_numpy(batch[0]),) + batch[1:]
    pers = ctc.make_ctc_cv_bucket_trainer(
        tb, tr, va, n_classes=V, win_size=WIN, stride=STRIDE, seed=SEED,
        model_chunk=model_chunk)(CFGS, EPOCHS, init_params=init)
    assert pers == pytest.approx(want, abs=1e-4)
    assert max(want) > 100.0  # symbols decoded
    _check_weights(got, len(init))


def test_plain_bucket_trainer_matches_jax(monkeypatch):
    """The held-out trainer against JAX's (its scan GRU, on bf16-rounded
    frames): validation PER per trial equal, final weights within
    WEIGHT_ATOL."""
    (x, y, il, ll), _, _ = _data(seed=1, bf16=True)
    train = (x[:12], y[:12], il[:12], ll[:12])
    val = (x[12:], y[12:], il[12:], ll[12:])
    got = _record(monkeypatch)
    want = jctc.make_ctc_bucket_trainer(
        tuple(jnp.asarray(a) for a in train),
        tuple(jnp.asarray(a) for a in val), n_classes=V, win_size=WIN,
        stride=STRIDE, seed=SEED)(CFGS, EPOCHS)
    init = _jax_init(len(CFGS), x)
    pers = ctc.make_ctc_bucket_trainer(
        (torch.from_numpy(train[0]),) + train[1:],
        (torch.from_numpy(val[0]),) + val[1:], n_classes=V, win_size=WIN,
        stride=STRIDE, seed=SEED)(CFGS, EPOCHS, init_params=init)
    assert pers == pytest.approx(want, abs=1e-4)
    _check_weights(got, len(init))


def test_epoch_segments_change_no_result(monkeypatch):
    """CPSD_EPOCH_SEG cuts the epochs into segments with a host read
    after each; the generators run on across the boundaries, so at dropout
    0.3 the weights and PERs equal the unsegmented run's bit for bit."""
    batch, tr, va = _data()
    tb = (torch.from_numpy(batch[0]),) + batch[1:]
    cfgs = [dict(c, dropout=0.3) for c in CFGS]
    got = _record(monkeypatch)
    runs = []
    for seg in (100, 2):
        monkeypatch.setattr(ctc, "EPOCH_SEG", seg)
        pers = ctc.make_ctc_cv_bucket_trainer(
            tb, tr, va, n_classes=V, win_size=WIN, stride=STRIDE,
            seed=SEED)(cfgs, 5)
        runs.append((pers, got["port"]))
        got["port"] = []
    (p1, w1), (p2, w2) = runs
    assert p1 == p2
    assert len(w1) == 4 and len(w2) == 4 * 3  # segments of 2, 2 and 1
    for a, b in zip(w1, w2[2::3]):
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_models_draw_their_own_seeds():
    """Without init_params, model i of a bucket draws its weights from
    seed + i and its dropout from seed + 1000 + i: the same bucket twice
    gives the same PERs, and the second trial's weights differ from the
    first's."""
    batch, tr, va = _data()
    tb = (torch.from_numpy(batch[0]),) + batch[1:]
    trainer = ctc.make_ctc_cv_bucket_trainer(
        tb, tr, va, n_classes=V, win_size=WIN, stride=STRIDE, seed=SEED)
    cfgs = [dict(c, dropout=0.3) for c in CFGS]
    assert trainer(cfgs, 2) == trainer(cfgs, 2)
    bucket = ctc._Bucket(ARCH, C, V, WIN, STRIDE, 0, 100, SEED, "cpu")
    m0 = bucket.train(0, 1e-3, 1e-4, 0, None, None, None, None, None)
    m1 = bucket.train(1, 1e-3, 1e-4, 0, None, None, None, None, None)
    assert not torch.equal(m0.rnn.layer(0).wi, m1.rnn.layer(0).wi)


def test_trainer_validation():
    """JAX's argument checks: per-fold x with the wrong fold count and
    model_chunk with a mesh raise ValueError. With a mesh of two gloo
    ranks (``torch_parallel_ranks.bucket_checks``) both trainers shard
    their models: the CV bucket's 2 trials x 3 folds and the holdout
    bucket's 2 trials give the unsharded trainers' PERs (atol 1e-9: the
    same models trained in turn); 1 trial x 3 folds do not divide the
    ranks, which warns, and every rank trains all three."""
    import torch_parallel_ranks as ranks

    from cross_patient_speech_decoding_tpu_torch import parallel

    batch, tr, va = _data(per_fold=True)
    tb = (torch.from_numpy(batch[0]),) + batch[1:]
    with pytest.raises(ValueError, match="folds"):
        ctc.make_ctc_cv_bucket_trainer(tb, tr[:1], va[:1], n_classes=V)
    one = parallel.make_mesh(1, device="cpu")
    with pytest.raises(ValueError, match="model_chunk"):
        ctc.make_ctc_cv_bucket_trainer(tb, tr, va, n_classes=V,
                                       model_chunk=1, mesh=one)
    batch, tr, va = _data(folds=3)
    kw = dict(n_classes=V, win_size=WIN, stride=STRIDE, seed=SEED)
    spec = dict(batch=batch, w_tr=tr, w_va=va, kw=kw, cfgs=CFGS, epochs=4)
    got = parallel.launch(ranks.bucket_checks, 2, (spec,), devices="cpu",
                          timeout=120)
    tb = (torch.from_numpy(batch[0]),) + batch[1:]
    with ranks.threads(1):
        cv = ctc.make_ctc_cv_bucket_trainer(tb, tr, va, **kw)
        want_cv, want_odd = cv(CFGS, 4), cv(CFGS[:1], 4)
        want_hold = ctc.make_ctc_bucket_trainer(tb, tb, **kw)(CFGS, 4)
    np.testing.assert_allclose(got["cv"], want_cv, atol=1e-9)
    np.testing.assert_allclose(got["cv_odd"], want_odd, atol=1e-9)
    np.testing.assert_allclose(got["holdout"], want_hold, atol=1e-9)
    assert any("UNSHARDED" in m for m in got["warned"])
