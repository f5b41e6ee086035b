"""The port's CTC sweep driver (``run_tune_ctc``, ``cpsd tune-ctc``)
against the JAX package's, on the CPU at small sizes.

Both drivers get the same data (both packages' synthetic caches filled
with the same host arrays), the same trials (the host samplers, bit for
bit, over a search space narrowed to small widths at dropout 0 in both
packages), JAX's PCA signs for the pooled prep (as
tests/test_torch_ctc_driver.py's ``_patch_pca_signs``) and the JAX
trainers' own initial weights, carried into the port's buckets through
``init_params=``. The JAX trainers run their Pallas GRU kernels in
interpret mode (``disable_pallas_gru`` made a no-op), which round the
layer-0 frames to bf16 as the port does; tests/test_torch_sweep_ctc.py
holds the trainers on JAX's scan path. Results must list the same
configs in the same order at the same budgets, with validation PERs
within 1e-3 (float32 PERs of equal decodes), and so must the manifests.
"""

import contextlib
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cross_patient_speech_decoding_tpu.ops.pallas_gru as pg
from cross_patient_speech_decoding_tpu import sweep as jsweep
from cross_patient_speech_decoding_tpu.cli import experiments as je
from cross_patient_speech_decoding_tpu.data import loaders as jload
from cross_patient_speech_decoding_tpu.data import synthetic as jsyn
from cross_patient_speech_decoding_tpu.models import RealtimeRNN as JaxRNN
from cross_patient_speech_decoding_tpu.sweep import bayes as jbayes
from cross_patient_speech_decoding_tpu.utils.config import (
    TuneCTCConfig as JaxCfg,
)
from cross_patient_speech_decoding_tpu_torch import sweep as tsweep
from cross_patient_speech_decoding_tpu_torch.cli import experiments as te
from cross_patient_speech_decoding_tpu_torch.cli import main as tmain
from cross_patient_speech_decoding_tpu_torch.models import (
    realtime_rnn_params_from_flax,
)
from cross_patient_speech_decoding_tpu_torch.sweep import ctc as tctc
from cross_patient_speech_decoding_tpu_torch.utils.config import (
    TrainCTCConfig,
    TuneCTCConfig,
)

torch.set_num_threads(2)

PER_ATOL = 1e-3
SMALL = dict(synth_T=40, synth_trials=54, synth_patients=3, seed=5,
             n_trials=3, rungs="2,4", eta=2)
HIDDEN, LAYERS = (8, 12), (2,)


@pytest.fixture
def small_space(monkeypatch):
    """Both packages' search spaces at small widths and dropout 0."""
    for mod in (jsweep, tsweep):
        monkeypatch.setattr(mod, "SweepSpace", functools.partial(
            mod.SweepSpace, hidden=HIDDEN, n_layers=LAYERS, dropout=(0.0,)))

    def space(mod, base=None):
        s = (base or mod.default_ctc_space)()
        s.update(hidden=mod.Categorical(HIDDEN),
                 n_layers=mod.Categorical(LAYERS),
                 dropout=mod.Categorical((0.0,)))
        return s

    base_t = tsweep.default_ctc_space
    monkeypatch.setattr(jbayes, "default_ctc_space",
                        lambda: space(jsweep))
    monkeypatch.setattr(tsweep, "default_ctc_space",
                        lambda: space(tsweep, base_t))


@pytest.fixture
def jax_kernels(monkeypatch):
    """The JAX trainers on their Pallas kernels (interpret mode) in every
    bucket, vmapped or not."""
    monkeypatch.setattr(pg, "enabled", lambda: True)
    monkeypatch.setattr(pg, "worthwhile", lambda B, T: True)
    monkeypatch.setattr(pg, "disable_pallas_gru", contextlib.nullcontext)


@pytest.fixture
def synth():
    def fill(cfg):
        chans = te._synthetic_ctc_channels(cfg)
        ds = jsyn.make_synthetic_patients(
            seed=cfg.seed, n_patients=cfg.synth_patients, n_classes=27,
            trials_per_class=cfg.synth_trials // 27, T=cfg.synth_T,
            channels=chans, latent_dim=12, noise=0.5, seq_len=3)
        host = [(X.astype(np.float32), y.astype(np.int32),
                 np.full(len(X), cfg.synth_T, np.int32),
                 np.full(len(X), 3, np.int32))
                for X, y in zip(ds.X, ds.y_seq)]
        key = (cfg.seed, cfg.synth_patients, cfg.synth_trials, cfg.synth_T,
               chans, 9, 3)
        je._SYNTH_CTC_CACHE.clear()
        je._SYNTH_CTC_CACHE[key] = [(jnp.asarray(X),) + tuple(r)
                                    for X, *r in host]
        te._SYNTH_CTC_CACHE.clear()
        te._SYNTH_CTC_CACHE[te._synthetic_ctc_key(*key, "cpu")] = [
            (torch.from_numpy(X.copy()),) + tuple(r) for X, *r in host]

    yield fill
    je._SYNTH_CTC_CACHE.clear()
    te._SYNTH_CTC_CACHE.clear()


def _patch_pca_signs(monkeypatch):
    """The port's per-patient PCA takes JAX's sign for each latent column
    (tests/test_torch_ctc_driver.py)."""
    orig = te._pca_fit_lat
    fit_j = je._ctc_prep_jit()[0]

    def fit(X, mask, n_comp, max_k):
        st, lat = orig(X, mask, n_comp, max_k)
        _, lat_j = fit_j(jnp.asarray(X.numpy()),
                         None if mask is None else jnp.asarray(mask.numpy()),
                         n_comp, max_k)
        dots = (lat * torch.from_numpy(np.array(lat_j))).sum((0, 1))
        signs = torch.where(dots < 0, -1.0, 1.0)
        return st._replace(components=st.components * signs), lat * signs

    monkeypatch.setattr(te, "_pca_fit_lat", fit)


def _jax_inits(cfgs, n_models, in_channels, seed):
    """The JAX trainers' initial weights of a bucket of n_models."""
    a = cfgs[0]
    model = JaxRNN(hidden=a["hidden"], n_layers=a["n_layers"], n_classes=11,
                   dropout=a["dropout"], win_size=14, stride=4)
    keys = jax.random.split(jax.random.key(seed), n_models)
    params = jax.vmap(lambda k: model.init(
        {"params": k}, jnp.zeros((1, 60, in_channels)))["params"])(keys)
    params = jax.tree_util.tree_map(np.asarray, params)
    return [realtime_rnn_params_from_flax(
        jax.tree_util.tree_map(lambda v: v[i], params))
        for i in range(n_models)]


def _patch_inits(monkeypatch, seed, folds):
    """The port's bucket trainers start from JAX's initial weights."""
    for name in ("make_ctc_bucket_trainer", "make_ctc_cv_bucket_trainer"):
        orig = getattr(tctc, name)

        def make(*a, _orig=orig, _cv=name.endswith("cv_bucket_trainer"),
                 **k):
            inner = _orig(*a, **k)
            x = a[0][0]
            F = folds if _cv else 1

            def train_bucket(cfgs, epochs):
                return inner(cfgs, epochs, init_params=_jax_inits(
                    cfgs, len(cfgs) * F, x.shape[-1], seed))
            return train_bucket

        monkeypatch.setattr(tctc, name, make)


def _strip(rec):
    return {k: v for k, v in rec.items()
            if k not in ("wall_s", "done_at", "metric")}


def _check_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["config"] == w["config"] and g["epochs"] == w["epochs"]
        assert abs(g["metric"] - w["metric"]) <= PER_ATOL


@pytest.mark.parametrize("context,cv,sampler", [
    ("patient", 0, "random"), ("aligned", 0, "tpe"),
    ("patient", 3, "tpe"), ("aligned", 3, "random")])
def test_run_tune_ctc_matches_jax(context, cv, sampler, tmp_path,
                                  monkeypatch, synth, small_space,
                                  jax_kernels):
    """Holdout and 3-fold CV, patient and aligned (per-fold refits),
    random and TPE: the same results and manifest records as JAX's
    driver."""
    kw = dict(SMALL, cv_folds=cv, sampler=sampler,
              align_train=context == "aligned", model_chunk=1 if cv else 0)
    cfg_j = JaxCfg(**kw, manifest=str(tmp_path / "j" / "m.jsonl"))
    cfg = TuneCTCConfig(**kw, manifest=str(tmp_path / "t" / "m.jsonl"))
    synth(cfg)
    want = je.run_tune_ctc(cfg_j, verbose=False)
    _patch_pca_signs(monkeypatch)
    _patch_inits(monkeypatch, cfg.seed, cv)
    got = te.run_tune_ctc(cfg, verbose=False, device="cpu")
    _check_results(got, want)
    recs = [json.loads(x) for x in open(cfg.manifest)]
    recs_j = [json.loads(x) for x in open(cfg_j.manifest)]
    assert [_strip(r) for r in recs] == [_strip(r) for r in recs_j]
    for r, rj in zip(recs, recs_j):
        assert abs(r["metric"] - rj["metric"]) <= PER_ATOL


def test_resume_and_hparam_handoff(tmp_path, monkeypatch, synth,
                                   small_space):
    """A second call with the same manifest trains nothing and returns the
    same results; hparam_out's file is read by JAX's load_tuned_hparams
    and by the port's train-ctc (hparam_dir=) as the winning config."""
    out = tmp_path / "hp"
    cfg = TuneCTCConfig(**SMALL, align_train=True, hparam_out=str(out),
                        manifest=str(tmp_path / "m.jsonl"))
    synth(cfg)
    got = te.run_tune_ctc(cfg, verbose=False, device="cpu")
    calls = []
    monkeypatch.setattr(tctc._Bucket, "train",
                        lambda *a, **k: calls.append(a))
    again = te.run_tune_ctc(cfg, verbose=False, device="cpu")
    assert not calls

    def key(r):
        return (-r["epochs"], r["metric"], json.dumps(r["config"]))

    assert sorted(again, key=key) == sorted(got, key=key)
    best = got[0]["config"]
    tuned = jload.load_tuned_hparams(
        str(out), "S14", "aligned",
        {"learning_rate": 0, "l2_reg": 0, "hidden_size": 0, "n_layers": 0,
         "dropout": 1.0})
    assert tuned == {"learning_rate": best["lr"],
                     "l2_reg": best["weight_decay"],
                     "hidden_size": best["hidden"],
                     "n_layers": best["n_layers"],
                     "dropout": best["dropout"]}
    tc = te._apply_tuned_hparams(TrainCTCConfig(hparam_dir=str(out),
                                                context="aligned"))
    assert (tc.lr, tc.weight_decay, tc.hidden, tc.n_layers, tc.dropout) == (
        best["lr"], best["weight_decay"], best["hidden"], best["n_layers"],
        best["dropout"])


def test_cli_tune_ctc_and_refusals(tmp_path, synth, capsys, small_space):
    """``cli.main tune-ctc device=cpu`` runs the sweep and returns 0;
    n_devices=2 runs it with each bucket's trials sharded over two gloo
    ranks (the search space narrowed inside the ranks,
    ``torch_parallel_ranks.tune_small``): every trial gets a finite
    metric, and rank 0 alone writes the manifest; without a card and
    without device=cpu the driver raises."""
    cfg = TuneCTCConfig(**SMALL)
    synth(cfg)
    args = [f"{k}={v}" for k, v in SMALL.items()]
    assert tmain.main(["tune-ctc", "device=cpu", *args,
                       f"manifest={tmp_path / 'm.jsonl'}"]) == 0
    assert "best val PER" in capsys.readouterr().out
    import torch_parallel_ranks as ranks

    from cross_patient_speech_decoding_tpu_torch import parallel

    manifest = tmp_path / "mesh.jsonl"
    res = parallel.launch(ranks.tune_small, 2, (TuneCTCConfig(
        **SMALL, n_devices=2, manifest=str(manifest)),), devices="cpu",
        timeout=300)
    assert len(res) == SMALL["n_trials"]
    assert all(np.isfinite(r["metric"]) for r in res)
    keys = [json.loads(line)["key"]
            for line in manifest.read_text().splitlines()]
    assert len(keys) == len(set(keys)) >= SMALL["n_trials"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            te.run_tune_ctc(TuneCTCConfig(**SMALL))
