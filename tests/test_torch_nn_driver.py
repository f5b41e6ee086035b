"""The port's NN-classifier decode driver (``run_train_nn``, ``cpsd
train-nn``) against the JAX package's, on the CPU at small sizes, for
all four model families.

Both drivers read one decoding-data pickle written in a temporary
directory (three patients, phoneme-position arrays), split it with the
same numpy draws and train at dropout 0 (the CNN-transformer's encoder
dropout, fixed at 0.1 in both packages' model switch, set to 0 on both
sides), where no random draw matters, from JAX's own initial weights
(carried over by ``nn_classifier_params_from_flax`` for each fold's seed)
with JAX's PCA signs (:func:`_patch_pca_signs`) and JAX's products at
full float32. Tolerances:

- the final epoch's test loss of every fold: rtol 1e-3, the bound to
  which the CCA-mapped features themselves agree
  (tests/test_torch_alignment.py's projection bound);
- accuracies: equal, except that each test trial whose top two logits lie
  within 1e-4 of their magnitude may flip: a fold's accuracy may then
  move by those trials' share of its test rows.
"""

import csv
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_patient_speech_decoding_tpu.cli import experiments as je
from cross_patient_speech_decoding_tpu.data import synthetic as jsyn
from cross_patient_speech_decoding_tpu.decoders import pooled as jpool
from cross_patient_speech_decoding_tpu.utils.config import (
    TrainNNConfig as JaxCfg,
)
import cross_patient_speech_decoding_tpu_torch.train as ttrain
from cross_patient_speech_decoding_tpu_torch.cli import experiments as te
from cross_patient_speech_decoding_tpu_torch.cli import main as tmain
from cross_patient_speech_decoding_tpu_torch.data import loaders
from cross_patient_speech_decoding_tpu_torch.models import (
    nn_classifier_params_from_flax,
)
from cross_patient_speech_decoding_tpu_torch.utils.config import (
    TrainNNConfig,
)

torch.set_num_threads(2)

LOSS_RTOL = 1e-3
DECIDED = 1e-4
N_FOLDS = 4
SMALL = dict(target_pt="S14", p_ind=1, n_iter=1, n_folds=N_FOLDS, epochs=2,
             n_filters=8, hidden=12, d_model=8, n_heads=2, n_layers=2,
             dim_ff=16, kernel_size=4, dropout=0.0, max_k=8, seed=1)


def _decoding_dict():
    """A ``pt_decoding_data`` dict in the reference's layout: three
    patients of 9 classes x 4 trials, T=16, phoneme position 1 arrays and
    the full sequences of 3."""
    ds = jsyn.make_synthetic_patients(seed=0, n_patients=3, n_classes=9,
                                      trials_per_class=4, T=16,
                                      channels=(20, 24, 18), latent_dim=5,
                                      noise=0.6)
    names = ["S14", "S26", "S33"]
    return {name: {"X1": ds.X[p].astype(np.float32),
                   "y1": ds.y_seq[p][:, 0], "y_full_phon": ds.y_seq[p],
                   "pre_pts": [m for m in names if m != name]}
            for p, name in enumerate(names)}


@pytest.fixture(scope="module")
def data_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("nn") / "pt_decoding_data.pkl"
    with open(path, "wb") as f:
        pickle.dump(_decoding_dict(), f)
    return str(path)


def _cfgs(root, data, **kw):
    kw = {**SMALL, "data": data, **kw}
    return (JaxCfg(out=str(root / "j" / "nn.pkl"), **kw),
            TrainNNConfig(out=str(root / "t" / "nn.pkl"), **kw))


def _no_encoder_dropout(mp):
    """Both packages' CNN-transformer with encoder dropout 0 (their model
    switches fix it at the class default, 0.1)."""
    make_j, make_t = je._make_nn_classifier, te._make_nn_classifier

    def jax_make(cfg, n_classes):
        m = make_j(cfg, n_classes)
        return m.clone(dropout=0.0) if cfg.model == "cnn_transformer" else m

    def port_make(cfg, in_features, n_classes, seed=0, device=None):
        m = make_t(cfg, in_features, n_classes, seed, device)
        for block in getattr(m, "blocks", ()):
            block.dropout = block.attn.dropout = 0.0
        return m

    mp.setattr(je, "_make_nn_classifier", jax_make)
    mp.setattr(te, "_make_nn_classifier", port_make)


def _patch_jax_init(mp, T):
    """The port's fold models start from JAX's initial weights for the
    same seed (``model.init(jax.random.key(seed), x[:1])``, whose values
    depend on the key and the shapes only)."""
    make_t = te._make_nn_classifier

    def make(cfg, in_features, n_classes, seed=0, device=None):
        m = make_t(cfg, in_features, n_classes, seed, device)
        v = je._make_nn_classifier(cfg, n_classes).init(
            jax.random.key(seed), jnp.zeros((1, T, in_features)))
        m.load_state_dict(nn_classifier_params_from_flax(
            jax.tree_util.tree_map(np.asarray, v["params"]),
            jax.tree_util.tree_map(np.asarray, v.get("batch_stats", {}))))
        return m

    mp.setattr(te, "_make_nn_classifier", make)


def _patch_pca_signs(mp):
    """A principal component's sign is free, and the packages choose it
    differently; a flipped latent is another input to train on. The port's
    PCA takes JAX's sign for each column (from JAX's fit of the same
    rows), so both runs train on the same features."""
    orig = te._nn_pca

    def pca(X, mask, n_comp, max_k):
        lat = orig(X, mask, n_comp, max_k)
        Xj = jnp.asarray(X.numpy())
        st = jpool._fit_pca_latents(
            Xj, n_comp, max_k,
            sample_mask=None if mask is None else jnp.asarray(mask.numpy()))
        lat_j = np.array(jpool._transform_latents(st, Xj, max_k))
        dots = (lat * torch.from_numpy(lat_j)).sum((0, 1))
        return lat * torch.where(dots < 0, -1.0, 1.0)

    mp.setattr(te, "_nn_pca", pca)


def _record_slack(mp, slack):
    """Per fold, the share of the test rows whose top two logits (on the
    port's side) lie within DECIDED of their magnitude."""
    make = ttrain.make_classifier_eval_step

    def make_eval(model):
        step = make(model)

        def run(batch):
            model.eval()
            with torch.no_grad():
                top2 = model(batch[0]).double().topk(2, dim=-1).values
            close = (top2[:, 0] - top2[:, 1]) <= DECIDED * top2.abs().amax(-1)
            slack.append(float(close.float().mean()))
            return step(batch)
        return run

    mp.setattr(ttrain, "make_classifier_eval_step", make_eval)


def _fold_losses(out, model):
    """(epoch, loss, acc) of each fold's log, which holds one record."""
    d = Path(out).parent / "logs" / f"S14_{model}_nnDecode"
    rows = []
    for k in range(N_FOLDS):
        with open(d / f"iter000_fold{k:02d}.csv") as f:
            recs = list(csv.DictReader(f))
        assert len(recs) == 1
        rows.append([float(recs[0][c]) for c in ("epoch", "loss", "acc")])
    return np.asarray(rows)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, data_path):
    """Both drivers for each family, from the same file, JAX's initial
    weights and PCA signs; keeps the accuracies, the per-fold slack, the
    configs and the fold logs."""
    out = {}
    with pytest.MonkeyPatch.context() as mp, \
            jax.default_matmul_precision("highest"):
        _no_encoder_dropout(mp)
        _patch_jax_init(mp, 16)
        _patch_pca_signs(mp)
        for model in te.NN_MODELS:
            root = tmp_path_factory.mktemp(model)
            cfg_j, cfg = _cfgs(root, data_path, model=model)
            accs_j = je.run_train_nn(cfg_j, verbose=False)
            slack = []
            with pytest.MonkeyPatch.context() as inner:
                _record_slack(inner, slack)
                accs = te.run_train_nn(cfg, verbose=False, device="cpu")
            out[model] = dict(
                cfg_j=cfg_j, cfg=cfg, accs_j=accs_j, accs=accs, slack=slack,
                losses_j=_fold_losses(cfg_j.out, model),
                losses=_fold_losses(cfg.out, model))
    return out


@pytest.mark.parametrize("model", te.NN_MODELS)
def test_fold_accuracies_match_jax(runs, model):
    r = runs[model]
    assert r["accs"].shape == r["accs_j"].shape == (1, N_FOLDS)
    assert len(r["slack"]) == N_FOLDS
    diff = np.abs(r["accs"] - r["accs_j"])[0]
    assert (diff <= np.asarray(r["slack"]) + 1e-6).all(), (
        r["accs"], r["accs_j"], r["slack"])
    assert 0.0 <= r["accs"].min() and r["accs"].max() <= 1.0


@pytest.mark.parametrize("model", te.NN_MODELS)
def test_fold_logs_match_jax(runs, model):
    """Each fold's log holds one record, the final epoch's test loss and
    accuracy (eval_every = epochs); the losses agree to LOSS_RTOL."""
    r = runs[model]
    np.testing.assert_array_equal(r["losses"][:, 0], SMALL["epochs"] - 1)
    np.testing.assert_allclose(r["losses"][:, 1], r["losses_j"][:, 1],
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("model", te.NN_MODELS)
def test_results_pickle_matches_jax(runs, model):
    r = runs[model]
    store, store_j = (loaders.load_pkl(c.out) for c in (r["cfg"],
                                                        r["cfg_j"]))
    assert set(store) == set(store_j) == {"accs", "params"}
    assert store["params"] == {**vars(r["cfg_j"]), "out": r["cfg"].out}
    assert len(store["accs"]) == 1
    np.testing.assert_array_equal(store["accs"][0], r["accs"][0])


def test_resume_trains_nothing(tmp_path, data_path, monkeypatch, capsys):
    """A second call with the same config returns the stored accuracies
    and trains nothing; a larger n_iter resumes after them; another
    config sets the file aside and starts afresh."""
    _, cfg = _cfgs(tmp_path, data_path, model="tcn")
    first = te.run_train_nn(cfg, verbose=True, device="cpu")
    make = ttrain.make_classifier_train_step
    calls = []
    monkeypatch.setattr(ttrain, "make_classifier_train_step",
                        lambda *a: (calls.append(1), make(*a))[1])
    again = te.run_train_nn(cfg, verbose=True, device="cpu")
    assert "resuming: 1/1 iterations done" in capsys.readouterr().out
    np.testing.assert_array_equal(again, first)
    assert calls == []
    more = te.run_train_nn(TrainNNConfig(**{**vars(cfg), "n_iter": 2}),
                           verbose=False, device="cpu")
    assert more.shape == (2, N_FOLDS) and len(calls) == N_FOLDS
    np.testing.assert_array_equal(more[0], first[0])
    other = te.run_train_nn(TrainNNConfig(**{**vars(cfg), "lr": 2e-3}),
                            verbose=False, device="cpu")
    assert other.shape == (1, N_FOLDS)
    assert len(list((tmp_path / "t" / "_stale").iterdir())) == 1


def test_cli_train_nn_runs_in_process(tmp_path, data_path, capsys):
    """``cli.main train-nn device=cpu`` runs the driver in this process,
    with key=value overrides; device= is not a config field."""
    out = tmp_path / "cli" / "nn.pkl"
    args = [f"{k}={v}" for k, v in SMALL.items()]
    assert tmain.main(["train-nn", "device=cpu", f"data={data_path}",
                       "model=conv_rnn", f"out={out}", *args]) == 0
    assert "iter 0 [conv_rnn]: mean test acc" in capsys.readouterr().out
    params = loaders.load_pkl(out)["params"]
    assert "device" not in params and params["model"] == "conv_rnn"


def test_unported_options_raise(tmp_path, data_path):
    """n_devices=2 trains every fold data-parallel on two gloo ranks that
    the driver launches (``conv_rnn``: per-shard BatchNorm statistics, a
    pad row in rank 1's shard of each odd batch): accuracies in [0, 1],
    the results pickle written once, by rank 0. An unknown model is
    refused by the model switch. The TensorBoard log (ported) runs: one
    run directory a fold."""
    _, cfg = _cfgs(tmp_path, data_path)
    mesh_out = tmp_path / "mesh" / "nn.pkl"
    accs = te.run_train_nn(TrainNNConfig(**{
        **vars(cfg), "n_devices": 2, "model": "conv_rnn", "batch_size": 7,
        "out": str(mesh_out)}), verbose=False, device="cpu")
    assert accs.shape == (1, N_FOLDS)
    assert ((accs >= 0) & (accs <= 1)).all()
    assert len(loaders.load_pkl(mesh_out)["accs"]) == 1
    with pytest.raises(ValueError, match="unknown model"):
        te._make_nn_classifier(TrainNNConfig(model="lstm"), 4, 3,
                               device="cpu")
    assert not (tmp_path / "t").exists()
    te.run_train_nn(TrainNNConfig(**{**vars(cfg), "log_format": "tb"}),
                    verbose=False, device="cpu")
    logs = tmp_path / "t" / "logs" / f"S14_{cfg.model}_nnDecode"
    runs = sorted(p.name for p in logs.iterdir())
    assert runs == [f"iter000_fold{k:02d}" for k in range(cfg.n_folds)]
    for run in runs:
        (ev,) = (logs / run).glob("events.out.tfevents.*")
        assert b"acc" in ev.read_bytes()
