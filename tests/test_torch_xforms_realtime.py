"""The port's ``make-xforms`` and ``realtime-sim`` drivers against the JAX
package's, on the CPU at small sizes.

make-xforms: the PCA is float64 numpy on the host in both packages, so
its components are held bit for bit; each source's ``gram`` CCA
projection within 1e-3 of its largest value (tests/test_torch_alignment.py's
projection bound). Synthetic runs fill both packages' caches with the
same host arrays; file runs read one h5 fixture like
tests/test_real_data_drivers.py's. realtime-sim: both drivers stream the
same checkpoint over the same numpy draw of the recording; the streamed
symbols are equal and the logits within 5e-3 (tests/test_realtime.py:57's
online bound).
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps
import torch
from torch import nn as tnn

from cross_patient_speech_decoding_tpu.cli import experiments as je
from cross_patient_speech_decoding_tpu.data import loaders as jload
from cross_patient_speech_decoding_tpu.data import synthetic as jsyn
from cross_patient_speech_decoding_tpu.models import torch_import as jti
from cross_patient_speech_decoding_tpu.realtime import (
    init_realtime_state as j_init_state,
)
from cross_patient_speech_decoding_tpu.realtime import (
    simulate_stream as j_simulate,
)
from cross_patient_speech_decoding_tpu.utils.config import (
    MakeXformsConfig as JaxXfCfg,
)
from cross_patient_speech_decoding_tpu.utils.config import (
    RealtimeSimConfig as JaxRtCfg,
)
from cross_patient_speech_decoding_tpu_torch.cli import experiments as te
from cross_patient_speech_decoding_tpu_torch.cli import main as tmain
from cross_patient_speech_decoding_tpu_torch.data import loaders
from cross_patient_speech_decoding_tpu_torch.models import torch_import as ti
from cross_patient_speech_decoding_tpu_torch.realtime import (
    init_realtime_state,
    simulate_stream,
)
from cross_patient_speech_decoding_tpu_torch.utils.config import (
    MakeXformsConfig,
    RealtimeSimConfig,
    TrainCTCConfig,
)

torch.set_num_threads(2)

PROJ_RTOL = 1e-3
STREAM_ATOL = 5e-3


def _close(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), f"{what}: {err}"


# ------------------------------------------------------------- make-xforms --

@pytest.mark.parametrize("n_components", [0.9, 0.5, 7.0, 300.0])
def test_offline_pca_components_bitwise(n_components):
    """Variance fractions and whole counts (one above the rank): the same
    components and latents as JAX's, bit for bit."""
    X = np.random.default_rng(0).normal(size=(12, 15, 9)).astype(np.float32)
    X[..., 0] *= 4.0
    W, lat = te._offline_pca_components(X, n_components)
    W_j, lat_j = je._offline_pca_components(X, n_components)
    np.testing.assert_array_equal(W, W_j)
    np.testing.assert_array_equal(lat, lat_j)
    for bad in (1.0, 2.5, 0.0):
        with pytest.raises(ValueError, match="n_components"):
            te._offline_pca_components(X, bad)


@pytest.fixture
def synth_default():
    """Both packages' synthetic caches at MakeXformsConfig's default scale
    (3 patients, 108 trials, T=200), the same host arrays."""
    cfg = MakeXformsConfig()
    chans = te._synthetic_ctc_channels(cfg)
    ds = jsyn.make_synthetic_patients(
        seed=cfg.seed, n_patients=3, n_classes=27, trials_per_class=4,
        T=200, channels=chans, latent_dim=12, noise=0.5, seq_len=3)
    host = [(X.astype(np.float32), y.astype(np.int32),
             np.full(len(X), 200, np.int32), np.full(len(X), 3, np.int32))
            for X, y in zip(ds.X, ds.y_seq)]
    key = (cfg.seed, 3, 120, 200, chans, 9, 3)
    je._SYNTH_CTC_CACHE.clear()
    je._SYNTH_CTC_CACHE[key] = [(jnp.asarray(X),) + tuple(r)
                                for X, *r in host]
    te._SYNTH_CTC_CACHE.clear()
    te._SYNTH_CTC_CACHE[te._synthetic_ctc_key(*key, "cpu")] = [
        (torch.from_numpy(X.copy()),) + tuple(r) for X, *r in host]
    yield
    je._SYNTH_CTC_CACHE.clear()
    te._SYNTH_CTC_CACHE.clear()


def _check_xforms(got, want):
    assert got["pca"].keys() == want["pca"].keys()
    for pt in want["pca"]:
        np.testing.assert_array_equal(got["pca"][pt], want["pca"][pt])
    assert got["cca"].keys() == want["cca"].keys()
    for k in want["cca"]:
        assert got["cca"][k].dtype == np.float64
        _close(got["cca"][k], want["cca"][k], PROJ_RTOL, str(k))


def test_make_xforms_synthetic_matches_jax(tmp_path, synth_default):
    """Synthetic data with one named source: the patient names (SYN
    filling), PCA components bit for bit, CCA projections within 1e-3,
    and the files' datasets equal to the returned arrays."""
    kw = dict(train_pts="S7")
    want = je.run_make_xforms(JaxXfCfg(
        **kw, pca_out=str(tmp_path / "j" / "p.h5"),
        cca_out=str(tmp_path / "j" / "c.h5")), verbose=False)
    cfg = MakeXformsConfig(**kw, pca_out=str(tmp_path / "t" / "p.h5"),
                           cca_out=str(tmp_path / "t" / "c.h5"))
    got = te.run_make_xforms(cfg, verbose=False, device="cpu")
    _check_xforms(got, want)
    assert list(got["pca"]) == ["S14", "S7", "SYN2"]
    for pt, W in got["pca"].items():
        np.testing.assert_array_equal(
            jload.load_pca_xform(cfg.pca_out, pt), W.T)
    for (src, tgt), M in got["cca"].items():
        np.testing.assert_array_equal(
            jload.load_cca_xform(cfg.cca_out, tgt, src), M)
    computed = te.compute_xforms(cfg, device="cpu")
    assert computed["names"] == ["S14", "S7", "SYN2"]
    _check_xforms(computed, want)


@pytest.fixture(scope="module")
def ctc_h5(tmp_path_factory):
    """A reference-layout CTC h5 of three patients (S33 train-only), as
    tests/test_real_data_drivers.py's fixture."""
    path = tmp_path_factory.mktemp("ctc") / "rt_data.h5"
    ds = jsyn.make_synthetic_patients(
        seed=11, n_patients=3, n_classes=9, trials_per_class=6, T=80,
        channels=(12, 10, 8), latent_dim=6, noise=0.4)
    rng = np.random.default_rng(5)
    for i, pt in enumerate(("S14", "S22", "S33")):
        X = np.asarray(ds.X[i], np.float32)
        y = np.asarray(ds.y_seq[i], np.int64)
        perm = rng.permutation(len(X))
        n_te = max(4, len(X) // 5)
        te_i, tr_i = perm[:n_te], perm[n_te:]
        if pt == "S33":
            jload.save_ctc_h5(path, pt, X[tr_i], y[tr_i])
        else:
            jload.save_ctc_h5(path, pt, X[tr_i], y[tr_i], X[te_i], y[te_i])
    return str(path)


def test_make_xforms_from_h5_feeds_train_ctc(ctc_h5, tmp_path):
    """From the h5 (one file for both outputs): the same transforms as
    JAX's, read back by JAX's loaders, and the port's train-ctc trains on
    them through pca_path=/cca_path=."""
    kw = dict(data=ctc_h5, target_pt="S14", train_pts="S22,S33",
              n_components=0.9)
    xf_j, xf = tmp_path / "j.h5", tmp_path / "t.h5"
    want = je.run_make_xforms(JaxXfCfg(**kw, pca_out=str(xf_j),
                                       cca_out=str(xf_j)), verbose=False)
    got = te.run_make_xforms(MakeXformsConfig(**kw, pca_out=str(xf),
                                              cca_out=str(xf)),
                             verbose=False, device="cpu")
    _check_xforms(got, want)
    k_t = jload.load_pca_xform(xf, "S14").shape[1]
    for src in ("S22", "S33"):
        assert jload.load_cca_xform(xf, "S14", src).shape == (
            got["pca"][src].shape[0], k_t)
    pers = te.run_train_ctc(TrainCTCConfig(
        data=ctc_h5, target_pt="S14", train_pts="S14,S22,S33",
        context="aligned", n_iter=1, epochs=3, hidden=16, n_layers=1,
        win_size=6, stride=3, n_sil=1, decay_steps=3, pca_path=str(xf),
        cca_path=str(xf), out=str(tmp_path / "ctc.pkl"), seed=0),
        verbose=False, device="cpu")
    assert pers.shape == (1,) and np.isfinite(pers).all()
    with pytest.raises(ValueError, match="train_pts"):
        te.run_make_xforms(MakeXformsConfig(data=ctc_h5, target_pt="S14",
                                            train_pts="S14"),
                           verbose=False, device="cpu")


def test_make_xforms_needs_h5py(monkeypatch, tmp_path, capsys):
    """Without h5py the driver raises an ImportError naming it before any
    work, and writes nothing; ``cli.main make-xforms device=cpu`` returns
    0 where h5py is installed."""
    import sys

    monkeypatch.setitem(sys.modules, "h5py", None)
    cfg = MakeXformsConfig(pca_out=str(tmp_path / "p.h5"),
                           cca_out=str(tmp_path / "c.h5"))
    with pytest.raises(ImportError, match="h5py"):
        te.run_make_xforms(cfg, device="cpu")
    assert not list(tmp_path.iterdir())
    monkeypatch.delitem(sys.modules, "h5py")
    assert tmain.main(["make-xforms", "device=cpu",
                       f"pca_out={tmp_path / 'p.h5'}",
                       f"cca_out={tmp_path / 'c.h5'}"]) == 0
    assert "CCA transforms ->" in capsys.readouterr().out


# ------------------------------------------------------------ realtime-sim --

def _ckpt(tmp_path, C=8, win=14, stride=4, H=16, L=2, K=11, seed=5):
    torch.manual_seed(seed)
    gru = tnn.GRU(win * C, H, num_layers=L, batch_first=True)
    head = tnn.Linear(H, K)
    sd = {f"rnn.rnn.{k}": v for k, v in gru.state_dict().items()}
    sd["h0"] = torch.randn(L, 1, H)
    sd.update({f"classifier.fc.{k}": v for k, v in head.state_dict().items()})
    with torch.no_grad():  # a head that emits symbols
        sd["classifier.fc.weight"] *= 8.0
    hp = dict(input_size=win * C, hidden_size=H, n_layers=L, n_classes=K,
              win_size=win, stride=stride, bidirectional=False, blank=0)
    path = tmp_path / "rt.ckpt"
    torch.save({"state_dict": sd, "hyper_parameters": hp}, path)
    return path


def _filters():
    bs, as_ = [], []
    for lo, hi in ((0.35, 0.5), (0.5, 0.65), (0.65, 0.8)):
        b, a = sps.butter(2, [lo, hi], btype="band")
        bs.append(b)
        as_.append(a)
    return np.stack(bs), np.stack(as_)


def test_realtime_sim_streams_the_checkpoint_as_jax(tmp_path, capsys):
    """One checkpoint, the drivers' recording (numpy draw from the seed)
    and filters: both packages' imported models stream the same symbols
    with logits within 5e-3; the drivers report the same emission count
    and take the checkpoint's architecture into the config."""
    path = _ckpt(tmp_path)
    n_bins = 80
    cfg = RealtimeSimConfig(n_bins=n_bins, ckpt=str(path), seed=2)
    res = te.run_realtime_sim(cfg, device="cpu")
    out_t = capsys.readouterr().out
    cfg_j = JaxRtCfg(n_bins=n_bins, ckpt=str(path), seed=2)
    je.run_realtime_sim(cfg_j)
    out_j = capsys.readouterr().out
    assert (cfg.n_channels, cfg.hidden, cfg.n_layers, cfg.n_classes) == (
        cfg_j.n_channels, cfg_j.hidden, cfg_j.n_layers, cfg_j.n_classes)
    assert out_t.split("amortized, ")[1] == out_j.split("amortized, ")[1]
    assert np.isfinite(res["amortized_ms"])
    assert res["p50_ms"] is None and res["p99_ms"] is None

    b, a = _filters()
    chunks = np.random.default_rng(2).normal(size=(n_bins, 8, 10))
    model = ti.realtime_rnn_from_ckpt(path, device="cpu").eval()
    _, (emit, logits, ran) = simulate_stream(
        model, init_realtime_state(model, b, a, 8),
        torch.as_tensor(chunks, dtype=torch.float32),
        torch.as_tensor(b, dtype=torch.float32),
        torch.as_tensor(a, dtype=torch.float32))
    jm, jp = jti.realtime_rnn_from_ckpt(path)
    _, (emit_j, logits_j, ran_j) = j_simulate(
        jm, jp, j_init_state(jm, jp, b, a, 8),
        jnp.asarray(chunks, jnp.float32), jnp.asarray(b, jnp.float32),
        jnp.asarray(a, jnp.float32))
    np.testing.assert_array_equal(ran.numpy(), np.asarray(ran_j))
    np.testing.assert_array_equal(emit.numpy(), np.asarray(emit_j))
    assert (emit.numpy() >= 0).sum() > 0
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j),
                               atol=STREAM_ATOL)


def test_realtime_sim_latency_and_out(tmp_path):
    """per_step_samples: p50 and max, p99 only from 100 samples; out=
    pickles JAX's keys; out= without samples raises ValueError."""
    kw = dict(n_bins=30, n_channels=6, hidden=8, n_layers=2,
              per_step_chain=3)
    res = te.run_realtime_sim(RealtimeSimConfig(**kw, per_step_samples=5),
                              verbose=False, device="cpu")
    assert res["p99_ms"] is None
    assert res["p50_ms"] <= res["max_ms"] and res["samples_ms"].shape == (5,)
    out = tmp_path / "lat" / "rt.pkl"
    res = te.run_realtime_sim(RealtimeSimConfig(
        **kw, per_step_samples=100, out=str(out)), verbose=False,
        device="cpu")
    assert res["p99_ms"] is not None and res["p99_ms"] <= res["max_ms"]
    out_j = tmp_path / "j.pkl"
    je.run_realtime_sim(JaxRtCfg(**kw, per_step_samples=100, out=str(out_j)),
                        verbose=False)
    with open(out, "rb") as f:
        got = pickle.load(f)
    with open(out_j, "rb") as f:
        want = pickle.load(f)
    assert got.keys() == want.keys()
    assert got["params"].keys() == want["params"].keys()
    assert got["samples_ms"].shape == want["samples_ms"].shape == (100,)
    assert loaders.load_pkl(out)["params"]["n_bins"] == 30
    with pytest.raises(ValueError, match="per_step_samples"):
        te.run_realtime_sim(RealtimeSimConfig(**kw, out=str(out)),
                            verbose=False, device="cpu")


def test_cli_realtime_sim(tmp_path, capsys):
    """``cli.main realtime-sim device=cpu`` streams and returns 0; without
    a card and without device=cpu it raises."""
    path = _ckpt(tmp_path)
    assert tmain.main(["realtime-sim", "device=cpu", "n_bins=40",
                       f"ckpt={path}", "per_step_samples=3",
                       "per_step_chain=2"]) == 0
    assert "per-step latency" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            te.run_realtime_sim(RealtimeSimConfig(n_bins=5))
