"""The port's CTC experiment driver (``run_train_ctc``, ``cpsd train-ctc``)
against the JAX package's, on the CPU at small sizes.

Both drivers get the same data: synthetic runs by filling both packages'
``_SYNTH_CTC_CACHE`` with the same arrays (the host generator, bit for bit
the same in both), file-backed runs by an h5 written in ``tmp_path``. The
parity runs start from JAX's initial weights (the port's ``_init_model``
is patched to load ``model.init(jax.random.key(seed + it))`` through
``realtime_rnn_params_from_flax``), at dropout 0 and without
augmentations, with the JAX model on its Pallas kernel path in interpret
mode as tests/test_torch_ctc_train.py pins it, so both sides round the
layer-0 frames to bf16. Tolerances are stated at each check.
"""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import cross_patient_speech_decoding_tpu.ops.pallas_gru as pg
from cross_patient_speech_decoding_tpu.cli import experiments as je
from cross_patient_speech_decoding_tpu.data import loaders as jload
from cross_patient_speech_decoding_tpu.data import synthetic as jsyn
from cross_patient_speech_decoding_tpu.models import RealtimeRNN as JaxRNN
from cross_patient_speech_decoding_tpu.utils.config import (
    TrainCTCConfig as JaxCfg,
)
from cross_patient_speech_decoding_tpu_torch.cli import experiments as te
from cross_patient_speech_decoding_tpu_torch.cli import main as tmain
from cross_patient_speech_decoding_tpu_torch.data import loaders
from cross_patient_speech_decoding_tpu_torch.models import (
    realtime_rnn_params_from_flax,
)
from cross_patient_speech_decoding_tpu_torch.utils.config import (
    TrainCTCConfig,
)

torch.set_num_threads(2)

# latents of the prep against JAX, relative to the largest value, column
# signs aligned: PCA 2e-4 (tests/test_torch_alignment.py's PCA bound),
# CCA-aligned 1e-3 (its projection bound)
PCA_RTOL = 2e-4
ALIGNED_RTOL = 1e-3
# per-epoch validation loss of the whole run against JAX: float32 training
# through the interpret-mode kernels and the port's plain GRU, two
# iterations of two epochs
VAL_LOSS_RTOL = 1e-3

SMALL = dict(hidden=8, n_layers=2, win_size=6, stride=2, synth_T=40,
             synth_trials=54, synth_patients=3, seed=11, epochs=2, n_iter=2,
             dropout=0.0, lr=2e-2, n_components=0.9, batch_size=48,
             decay_steps=100)


@pytest.fixture
def jax_kernel_path(monkeypatch):
    monkeypatch.setattr(pg, "enabled", lambda: True)
    monkeypatch.setattr(pg, "worthwhile", lambda B, T: True)


def _cfgs(**kw):
    kw = {**SMALL, **kw}
    return JaxCfg(**kw), TrainCTCConfig(**kw)


@pytest.fixture
def synth():
    """Fill both packages' synthetic caches with the same host arrays for a
    config; both caches are emptied afterwards, so no later test in the
    process sees the injected data."""

    def fill(cfg):
        chans = te._synthetic_ctc_channels(cfg)
        ds = jsyn.make_synthetic_patients(
            seed=cfg.seed, n_patients=cfg.synth_patients, n_classes=27,
            trials_per_class=cfg.synth_trials // 27, T=cfg.synth_T,
            channels=chans, latent_dim=12, noise=0.5, seq_len=3)
        host = []
        for X, y in zip(ds.X, ds.y_seq):
            n = len(X)
            host.append((X.astype(np.float32), y.astype(np.int32),
                         np.full(n, cfg.synth_T, np.int32),
                         np.full(n, 3, np.int32)))
        key = (cfg.seed, cfg.synth_patients, cfg.synth_trials, cfg.synth_T,
               chans, 9, 3)
        je._SYNTH_CTC_CACHE.clear()
        je._SYNTH_CTC_CACHE[key] = [(jnp.asarray(X),) + tuple(r)
                                    for X, *r in host]
        te._SYNTH_CTC_CACHE.clear()
        te._SYNTH_CTC_CACHE[te._synthetic_ctc_key(*key, "cpu")] = [
            (torch.from_numpy(X.copy()),) + tuple(r) for X, *r in host]
        return host

    yield fill
    je._SYNTH_CTC_CACHE.clear()
    te._SYNTH_CTC_CACHE.clear()


def _signed_close(got, want, rtol, what):
    """Latents (N, T, K) equal up to the sign of each column, within rtol of
    the largest value."""
    got = np.asarray(got, np.float64).reshape(-1, got.shape[-1])
    want = np.asarray(want, np.float64).reshape(-1, want.shape[-1])
    assert got.shape == want.shape, what
    signs = np.where((got * want).sum(0) < 0, -1.0, 1.0)
    err = np.abs(got * signs - want).max()
    assert err <= rtol * np.abs(want).max(), f"{what}: {err}"


def _check_prep(got, want, context):
    (ds, C, test), (ds_j, C_j, test_j) = got, want
    assert C == C_j and len(ds) == len(ds_j)
    assert (test is None) == (test_j is None)
    pairs = list(zip(ds, ds_j)) + ([] if test is None else [(test, test_j)])
    for i, (d, dj) in enumerate(pairs):
        for a, b in zip(d[1:], dj[1:]):  # labels, lengths: exact
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        X = d[0].numpy() if torch.is_tensor(d[0]) else d[0]
        Xj = np.asarray(dj[0])
        if context in ("chance", "patient") or C != te.MAX_K:
            np.testing.assert_allclose(X, Xj, rtol=1e-6, atol=1e-6)
        else:
            rtol = ALIGNED_RTOL if context == "aligned" and 0 < i < len(
                ds) else PCA_RTOL
            _signed_close(X, Xj, rtol, f"{context} set {i}")


@pytest.mark.parametrize("context", ["chance", "patient", "unaligned",
                                     "aligned"])
def test_prep_synthetic_matches_jax(context, synth):
    """_prep_ctc_context on injected synthetic data, with the target train
    mask of an iteration: chance labels from the same rng equal, latents
    equal up to column sign."""
    cfg_j, cfg = _cfgs(context=context, chance_mode="permute")
    synth(cfg)
    mask = (np.random.default_rng(0).random(54) < 0.6).astype(np.float64)
    kw = {} if context in ("chance", "patient") else {"tar_train_mask": mask}
    got = te._prep_ctc_context(cfg, np.random.default_rng(3), device="cpu",
                               **kw)
    want = je._prep_ctc_context(cfg_j, np.random.default_rng(3), **kw)
    _check_prep(got, want, context)


@pytest.fixture(scope="module")
def h5_data(tmp_path_factory):
    """A CTC h5 of three patients (S3 train-only) from the host synthetic
    generator, and offline PCA/CCA transforms for them."""
    d = tmp_path_factory.mktemp("ctc_h5")
    ds = jsyn.make_synthetic_patients(seed=4, n_patients=3, n_classes=27,
                                      trials_per_class=2, T=41,
                                      channels=(10, 12, 9), latent_dim=5,
                                      noise=0.5)
    path = d / "ctc.h5"
    for pt, X, y in zip(("S1", "S2", "S3"), ds.X, ds.y_seq):
        X = X.astype(np.float32)
        if pt == "S3":
            jload.save_ctc_h5(path, pt, X, y)
        else:
            jload.save_ctc_h5(path, pt, X[:40], y[:40], X[40:], y[40:])
    rng = np.random.default_rng(5)
    pca = {pt: rng.normal(size=(4, X.shape[-1]))
           for pt, X in zip(("S1", "S2", "S3"), ds.X)}
    cca = {(src, tgt): rng.normal(size=(4, 4))
           for src in ("S1", "S2", "S3") for tgt in ("S1", "S2")
           if src != tgt}
    jload.save_xforms_h5(d / "xf.h5", pca=pca, cca=cca)
    return str(path), str(d / "xf.h5")


@pytest.mark.parametrize("context,xforms,align_pt", [
    ("patient", False, ""), ("chance", False, ""),
    ("unaligned", False, ""), ("aligned", False, ""),
    ("unaligned", True, ""), ("aligned", True, ""), ("aligned", True, "S2"),
])
def test_prep_file_backed_matches_jax(context, xforms, align_pt, h5_data):
    """_prep_ctc_context from the h5, on-the-fly PCA/CCA or the offline
    transforms (pca_path/cca_path, with the alignment space the target or
    another patient), with a target subsample: exact where no fit runs,
    latents up to column sign otherwise."""
    path, xf = h5_data
    kw = dict(data=path, target_pt="S1", train_pts="S1,S2,S3",
              only_train_pts="S3", context=context, tw_orig="0,4",
              tw_select="0.5,3.5", target_subsample=0.7, n_sil=1,
              align_pt=align_pt)
    if xforms:
        kw.update(pca_path=xf, cca_path=xf)
    cfg_j, cfg = _cfgs(**kw)
    got = te._prep_ctc_context(cfg, np.random.default_rng(8), device="cpu")
    want = je._prep_ctc_context(cfg_j, np.random.default_rng(8))
    _check_prep(got, want, context)


def _patch_init(monkeypatch):
    """The port's model of iteration it starts from JAX's
    ``model.init(jax.random.key(seed + it))``, as the JAX driver's."""
    orig = te._init_model

    def init(cfg, in_channels, it, device):
        m = orig(cfg, in_channels, it, device)
        jm = JaxRNN(hidden=cfg.hidden, n_layers=cfg.n_layers, n_classes=11,
                    dropout=cfg.dropout, win_size=cfg.win_size,
                    stride=cfg.stride)
        params = jm.init(jax.random.key(cfg.seed + it),
                         jnp.zeros((1, cfg.synth_T, in_channels)))
        m.load_state_dict(realtime_rnn_params_from_flax(
            jax.tree_util.tree_map(np.asarray, params)))
        return m

    monkeypatch.setattr(te, "_init_model", init)


def _patch_pca_signs(monkeypatch):
    """A principal component's sign is free, and LAPACK's choice differs
    between the packages; a flipped latent is another input to train on.
    The port's per-patient PCA takes JAX's sign for each column (from
    JAX's fit of the same rows), so both runs train on the same data."""
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


def _history(out, run_name, it):
    path = os.path.join(os.path.dirname(out), "logs", run_name,
                        f"iter{it:03d}.csv")
    with open(path) as f:
        return [{k: float(v) for k, v in r.items()} for r in csv.DictReader(f)]


@pytest.mark.parametrize("context", ["patient", "aligned"])
def test_run_train_ctc_matches_jax(context, tmp_path, monkeypatch, synth,
                                   jax_kernel_path):
    """Two iterations of two epochs (minibatches of 48, the same numpy
    permutations) from JAX's initial weights, with JAX's PCA signs (see
    :func:`_patch_pca_signs`): every epoch's validation
    loss within 1e-3 relative (they agree to ~1e-6 here), validation and
    test PER per iteration within one edit of the set's label total. After
    two epochs at this width the decodes are still all blank (PER 100 on
    both sides); decoding with symbols is held to JAX by
    :func:`test_beam_rescore_matches_jax` and the eval-step tests."""
    cfg_j, cfg = _cfgs(context=context, out=str(tmp_path / "j" / "ctc.pkl"))
    synth(cfg)
    pers_j = je.run_train_ctc(cfg_j, verbose=False)
    _patch_init(monkeypatch)
    _patch_pca_signs(monkeypatch)
    cfg.out = str(tmp_path / "t" / "ctc.pkl")
    pers = te.run_train_ctc(cfg, verbose=False, device="cpu")
    run_name = f"S14_{te._CONTEXT_NAMES[context]}_ctcRnn"
    # 54 target trials: 11 test and 11 validation rows of 3 labels
    one_edit = 100.0 / (11 * 3)
    assert pers.shape == pers_j.shape == (2,)
    assert np.abs(pers - pers_j).max() <= one_edit + 1e-9
    for it in range(2):
        h, hj = _history(cfg.out, run_name, it), _history(cfg_j.out,
                                                          run_name, it)
        assert [r["epoch"] for r in h] == [r["epoch"] for r in hj] == [0, 1]
        for r, rj in zip(h, hj):
            np.testing.assert_allclose(r["loss"], rj["loss"],
                                       rtol=VAL_LOSS_RTOL)
            assert abs(r["per"] - rj["per"]) <= one_edit + 1e-9
    assert jload.load_pkl(cfg.out)["params"] == {
        **vars(cfg_j), "out": cfg.out}


def test_beam_rescore_matches_jax(jax_kernel_path):
    """decode=beam: the port's _beam_rescore_per on a model holding JAX's
    weights gives JAX's PER on the same batch (beam 8); the port's logits
    are within 1e-5 of JAX's, and the decodes equal."""
    cfg_j, cfg = _cfgs(decode="beam", beam_size=8)
    jm = JaxRNN(hidden=8, n_layers=2, n_classes=11, dropout=0.0, win_size=6,
                stride=2)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(12, 40, 5)).astype(np.float32)
    y = rng.integers(1, 10, size=(12, 3)).astype(np.int32)
    il = rng.integers(30, 41, size=12).astype(np.int32)
    ll = np.full(12, 3, np.int32)
    params = jm.init(jax.random.key(0), jnp.asarray(x[:1]))
    # a head that emits symbols: the +2 blank bias makes every decode empty
    params = jax.tree_util.tree_map(np.asarray, params)
    params["params"]["head"]["bias"] = np.zeros(11, np.float32)
    params["params"]["head"]["kernel"] = params["params"]["head"][
        "kernel"] * 20
    state_j = type("S", (), {"params": params["params"]})()
    per_j = je._beam_rescore_per(jm, state_j,
                                 tuple(jnp.asarray(a) for a in (x, y, il, ll)),
                                 cfg_j)
    tm = te._init_model(cfg, 5, 0, "cpu")
    tm.load_state_dict(realtime_rnn_params_from_flax(params))
    per = te._beam_rescore_per(tm, tuple(torch.from_numpy(a)
                                         for a in (x, y, il, ll)), cfg)
    assert 0.0 < per_j < 100.0 * 40 / 3
    assert per == per_j


def _quick(tmp_path, **kw):
    return TrainCTCConfig(**{**SMALL, "n_iter": 1, "epochs": 1,
                             "context": "patient",
                             "out": str(tmp_path / "ctc.pkl"), **kw})


def test_resume_and_set_aside_behave_as_in_jax(tmp_path, synth, capsys,
                                               monkeypatch):
    """A rerun with the same config resumes from the pkl (no iteration
    runs: training is patched to fail); a larger n_iter runs only the
    missing iteration; another context sets the file aside into _stale/
    and starts afresh, as JAX's driver does."""
    cfg = _quick(tmp_path, n_iter=1)
    synth(cfg)
    first = te.run_train_ctc(cfg, verbose=False, device="cpu")

    def boom(*a, **k):
        raise AssertionError("no iteration may run on resume")

    with monkeypatch.context() as m:
        m.setattr(te, "_init_model", boom)
        again = te.run_train_ctc(cfg, verbose=True, device="cpu")
    np.testing.assert_array_equal(again, first)
    assert "resuming: 1/1" in capsys.readouterr().out
    cfg2 = _quick(tmp_path, n_iter=2)
    two = te.run_train_ctc(cfg2, verbose=False, device="cpu")
    assert two[0] == first[0] and len(two) == 2
    assert len(jload.load_pkl(cfg.out)["accs"]) == 2
    # JAX reads the port's store as its own: same config, resumes
    assert je._completed_results(cfg.out, {**vars(cfg2)}) == list(two)
    other = _quick(tmp_path, context="chance")
    te.run_train_ctc(other, verbose=False, device="cpu")
    stale = list((tmp_path / "_stale").iterdir())
    assert len(stale) == 1 and stale[0].name.endswith("_ctc.pkl")
    assert jload.load_pkl(stale[0])["params"]["context"] == "patient"
    assert jload.load_pkl(cfg.out)["params"]["context"] == "chance"


def test_set_aside_keeps_sibling_stems(tmp_path):
    """Intended difference from JAX: pruning a file's set-asides leaves
    those of a sibling stem alone. JAX's glob ``*_ctc.pkl`` also matches
    ``{ts}_x_ctc.pkl`` and deletes it (cli/experiments.py:1376); the port
    matches the timestamp prefix exactly."""
    stale = tmp_path / "_stale"
    stale.mkdir()
    sib = stale / "20200101-000000_x_ctc.pkl"
    sib.write_bytes(b"sibling")
    os.utime(sib, ns=(1, 1))  # the oldest file there
    for mod in (te, je):
        for _ in range(te.STALE_KEEP):
            (tmp_path / "ctc.pkl").write_bytes(b"x")
            mod._set_aside_stale(tmp_path / "ctc.pkl")
        if mod is te:
            assert sib.exists()
            assert len(te._stale_copies(stale, "ctc.pkl")) == te.STALE_KEEP
            assert te._stale_copies(stale, "x_ctc.pkl") == [sib]
    assert not sib.exists()  # JAX pruned the sibling's copy


def test_results_h5_read_by_jax(tmp_path, synth):
    """results_h5 written by the port's driver is read by JAX's
    load_ctc_results_h5: the PERs, the logits of each iteration from the
    pkl, the token table and the model's hyperparameters."""
    cfg = _quick(tmp_path, n_iter=2, save_logits=True,
                 results_h5=str(tmp_path / "res" / "r.h5"))
    synth(cfg)
    pers = te.run_train_ctc(cfg, verbose=False, device="cpu")
    got = jload.load_ctc_results_h5(cfg.results_h5)
    np.testing.assert_array_equal(got["phoneme_error_rate"], pers)
    # 11 test rows, (40 - 6) // 2 + 1 = 18 windows, 11 classes
    assert got["logits"].shape == (2, 11, 18, 11)
    np.testing.assert_allclose(np.exp(got["logits"]).sum(-1), 1.0,
                               rtol=1e-5)
    assert got["phon_dict"][10] == "sil"
    assert got["model_hparams"]["hidden_size"] == 8


def test_cli_train_ctc_runs_in_process(tmp_path, synth, capsys):
    """``cli.main train-ctc device=cpu`` runs the driver in this process,
    with key=value overrides; device= is not a config field. ``reproduce``
    and ``analyze`` run too: a dry run of a manifest holding this job (it
    is complete) and the statistics of two results pickles."""
    cfg = _quick(tmp_path)
    synth(cfg)
    args = [f"{k}={v}" for k, v in vars(cfg).items()
            if v != getattr(TrainCTCConfig, k)]
    assert tmain.main(["train-ctc", "device=cpu", *args]) == 0
    assert "iter 0 [patient]: test PER" in capsys.readouterr().out
    assert "device" not in loaders.load_pkl(cfg.out)["params"]
    manifest = tmp_path / "m.yaml"
    manifest.write_text(yaml.safe_dump({"jobs": [{
        "command": "train-ctc",
        "overrides": {k: v for k, v in vars(cfg).items()
                      if v != getattr(TrainCTCConfig, k)}}]}))
    assert tmain.main(["reproduce", f"manifest={manifest}",
                       "dry_run=true"]) == 0
    assert "complete, skipping" in capsys.readouterr().out
    rng = np.random.default_rng(0)
    for name in ("a", "b"):
        loaders.save_pkl({"accs": [rng.random(4) for _ in range(6)]},
                         tmp_path / f"{name}.pkl")
    assert tmain.main(["analyze", f"inputs=a={tmp_path / 'a.pkl'},"
                       f"b={tmp_path / 'b.pkl'}"]) == 0
    assert "wilcoxon a vs b" in capsys.readouterr().out


def test_unported_branches_raise(tmp_path, synth):
    cfg = _quick(tmp_path)
    # a bidirectional checkpoint: the port refuses it before any training,
    # with a ValueError that names the cause; JAX's driver builds a
    # unidirectional model and fails at its first apply on the checkpoint's
    # (4, 1, 8) h0 (an intended difference, checked below)
    gru = torch.nn.GRU(6 * 64, 8, num_layers=2, batch_first=True,
                       bidirectional=True)
    sd = {f"rnn.rnn.{k}": v for k, v in gru.state_dict().items()}
    sd.update({"h0": torch.zeros(4, 1, 8),
               "classifier.fc.weight": torch.zeros(11, 16),
               "classifier.fc.bias": torch.zeros(11)})
    torch.save({"state_dict": sd, "hyper_parameters": {
        "win_size": 6, "stride": 2, "bidirectional": True}},
        tmp_path / "bi.ckpt")
    bi_cfg = _quick(tmp_path, init_ckpt=str(tmp_path / "bi.ckpt"))
    with pytest.raises(ValueError, match="bidirectional"):
        te.run_train_ctc(bi_cfg, device="cpu")
    # n_devices=2 (data-parallel, two gloo ranks the driver launches; they
    # make their own synthetic data): finite PER, written once by rank 0
    mesh_cfg = _quick(tmp_path, n_devices=2,
                      out=str(tmp_path / "mesh" / "ctc.pkl"))
    per = te.run_train_ctc(mesh_cfg, verbose=False, device="cpu")
    assert per.shape == (1,) and np.isfinite(per).all()
    assert len(loaders.load_pkl(mesh_cfg.out)["accs"]) == 1
    synth(cfg)
    with pytest.raises(Exception, match="h0"):
        je.run_train_ctc(JaxCfg(**{**vars(bi_cfg),
                                   "out": str(tmp_path / "j" / "ctc.pkl")}),
                         verbose=False)
    # the TensorBoard log (ported): one run directory an iteration
    te.run_train_ctc(_quick(tmp_path, log_format="tb"), verbose=False,
                     device="cpu")
    run_dir = (tmp_path / "logs"
               / f"S14_{te._CONTEXT_NAMES['patient']}_ctcRnn" / "iter000")
    (ev,) = run_dir.glob("events.out.tfevents.*")
    data = ev.read_bytes()
    assert b"brain.Event:2" in data and b"loss" in data


def test_augmentations_and_subsample_on_the_driver(tmp_path, synth):
    """augmentations=all stacks five copies of the pooled train set (each
    transform on the original) with repeated labels; the cross subsample
    keeps every first-label class; both run through one iteration."""
    names = te._parse_augmentations("all")
    assert names == te._CTC_AUGS
    assert te._parse_augmentations("scaling, noise_jitter") == (
        "scaling", "noise_jitter")
    with pytest.raises(ValueError, match="unknown"):
        te._parse_augmentations("mixup")
    x = torch.randn(4, 20, 3)
    batch = (x, torch.ones(4, 3, dtype=torch.int32),
             torch.full((4,), 20), torch.full((4,), 3))
    out = te._apply_ctc_augmentations(batch, names,
                                      torch.Generator().manual_seed(0))
    assert out[0].shape == (24, 20, 3) and out[1].shape == (24, 3)
    assert torch.equal(out[0][:4], x)
    rng = np.random.default_rng(0)
    y = np.repeat(np.arange(1, 4), 4)[:, None] * np.ones((1, 3), np.int32)
    d = (torch.arange(12.0)[:, None], y, np.arange(12), np.arange(12))
    sub = te._subsample_ctc_set(d, 0.5, np.random.default_rng(0))
    want = je._subsample_ctc_set((np.arange(12.0)[:, None],) + d[1:], 0.5,
                                 rng)
    np.testing.assert_array_equal(sub[0].numpy(), want[0])
    np.testing.assert_array_equal(sub[2], want[2])
    cfg = _quick(tmp_path, context="aligned", augmentations="all",
                 cross_subsample=0.5)
    synth(cfg)
    pers = te.run_train_ctc(cfg, verbose=False, device="cpu")
    assert pers.shape == (1,) and 0.0 <= pers[0]
