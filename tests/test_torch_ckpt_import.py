"""The port's checkpoint import (``models/torch_import.py``) and
``train-ctc init_ckpt=`` against the JAX package's, on the CPU.

Fake Lightning checkpoints are written with ``torch.save`` in the
reference's key layout (``rnn.rnn.*``, ``h0``, ``classifier.fc.*``), as
tests/test_torch_import.py (the JAX package's own test) does. Both
packages import them; the weights must be equal bit for bit, and the
logits agree to float32 roundoff (atol 1e-5) with the JAX model on its
Pallas kernel path in interpret mode, which rounds the layer-0 frames to
bf16 as the port does.
"""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn as tnn

import cross_patient_speech_decoding_tpu.ops.pallas_gru as pg
from cross_patient_speech_decoding_tpu.cli import experiments as je
from cross_patient_speech_decoding_tpu.data import synthetic as jsyn
from cross_patient_speech_decoding_tpu.models import torch_import as jti
from cross_patient_speech_decoding_tpu.utils.config import (
    TrainCTCConfig as JaxCfg,
)
from cross_patient_speech_decoding_tpu_torch.cli import experiments as te
from cross_patient_speech_decoding_tpu_torch.cli import main as tmain
from cross_patient_speech_decoding_tpu_torch.models import (
    realtime_rnn_params_from_flax,
    seq2seq_params_from_flax,
)
from cross_patient_speech_decoding_tpu_torch.models import torch_import as ti
from cross_patient_speech_decoding_tpu_torch.utils.config import (
    TrainCTCConfig,
)

torch.set_num_threads(2)

LOGITS_ATOL = 1e-5
VAL_LOSS_RTOL = 1e-3  # as tests/test_torch_ctc_driver.py


@pytest.fixture
def jax_kernel_path(monkeypatch):
    monkeypatch.setattr(pg, "enabled", lambda: True)
    monkeypatch.setattr(pg, "worthwhile", lambda B, T: True)


def _rt_ckpt(tmp_path, name, C=3, win=6, stride=2, H=8, L=2, K=5,
             bidir=False, cell="gru", seed=0, hp_extra=None, bare=False):
    torch.manual_seed(seed)
    n_dir = 2 if bidir else 1
    rnn = (tnn.GRU if cell == "gru" else tnn.LSTM)(
        win * C, H, num_layers=L, batch_first=True, bidirectional=bidir)
    head = tnn.Linear(H * n_dir, K)
    sd = {f"rnn.rnn.{k}": v for k, v in rnn.state_dict().items()}
    sd["h0"] = torch.randn(L * n_dir, 1, H)
    sd.update({f"classifier.fc.{k}": v for k, v in head.state_dict().items()})
    hp = dict(input_size=win * C, hidden_size=H, n_layers=L, n_classes=K,
              dropout=0.3, win_size=win, stride=stride, bidirectional=bidir,
              blank=0, **(hp_extra or {}))
    path = tmp_path / name
    torch.save(sd if bare else {"state_dict": sd, "hyper_parameters": hp,
                                "epoch": 3}, path)
    return path, sd


def test_load_and_layer_maps_match_jax(tmp_path):
    """load_lightning_ckpt (full and bare), gru_params_from_torch and
    stacked_rnn_params_from_torch give JAX's arrays bit for bit."""
    path, _ = _rt_ckpt(tmp_path, "rt.ckpt")
    bare, _ = _rt_ckpt(tmp_path, "bare.pt", bare=True)
    for p in (path, bare):
        (sd, hp), (sd_j, hp_j) = ti.load_lightning_ckpt(p), \
            jti.load_lightning_ckpt(p)
        assert hp == hp_j and sd.keys() == sd_j.keys()
        for k in sd:
            np.testing.assert_array_equal(sd[k], sd_j[k])
    sd, _ = ti.load_lightning_ckpt(path)
    got = ti.stacked_rnn_params_from_torch(sd, "rnn.rnn", 2)
    want = jti.stacked_rnn_params_from_torch(sd, "rnn.rnn", 2)
    assert got.keys() == want.keys()
    for layer in got:
        for k in got[layer]:
            np.testing.assert_array_equal(got[layer][k], want[layer][k])
    assert ti._infer_gru_stack(sd, "rnn.rnn") == jti._infer_gru_stack(
        sd, "rnn.rnn")


@pytest.mark.parametrize("geom", [dict(), dict(C=4, win=4, stride=3, H=6,
                                               L=3, K=11),
                                  dict(bidir=True, H=6, L=3)])
def test_realtime_rnn_from_ckpt_matches_jax(tmp_path, geom,
                                            jax_kernel_path):
    """One checkpoint into both packages: the architecture, the weights
    bit for bit, and the logits within 1e-5."""
    path, _ = _rt_ckpt(tmp_path, "rt.ckpt", **geom)
    model = ti.realtime_rnn_from_ckpt(path, device="cpu")
    jm, jvars = jti.realtime_rnn_from_ckpt(path)
    for attr in ("hidden", "n_layers", "n_classes", "win_size", "stride",
                 "bidirectional", "blank"):
        assert getattr(model, attr) == getattr(jm, attr), attr
    want = realtime_rnn_params_from_flax(
        jax.tree_util.tree_map(np.asarray, jvars))
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    x = np.random.default_rng(1).normal(
        size=(4, 26, model.in_channels)).astype(np.float32)
    model.eval()
    with torch.no_grad():
        logits = model(torch.from_numpy(x)).numpy()
    logits_j = np.asarray(jm.apply(jvars, jnp.asarray(x)))
    np.testing.assert_allclose(logits, logits_j, atol=LOGITS_ATOL)


def test_state_dict_round_trip(tmp_path):
    """realtime_rnn_to_state_dict inverts the import bit for bit, from the
    module or its state dict, and equals JAX's inverse map."""
    path, sd = _rt_ckpt(tmp_path, "rt.ckpt", L=3)
    model = ti.realtime_rnn_from_ckpt(path, device="cpu")
    _, jvars = jti.realtime_rnn_from_ckpt(path)
    want = jti.realtime_rnn_to_state_dict(jvars)
    for src in (model, model.state_dict()):
        back = ti.realtime_rnn_to_state_dict(src)
        assert set(back) == set(sd) == set(want)
        for k in sd:
            np.testing.assert_array_equal(back[k], sd[k].numpy())
            np.testing.assert_array_equal(back[k], want[k])


def test_unported_and_invalid_checkpoints_raise(tmp_path):
    """What was refused before the LSTM and bidirectional ports now
    imports: a bidirectional streaming checkpoint, and the LSTM layer and
    stack maps (bit for bit JAX's, the two biases summed). Invalid
    checkpoints still raise as in JAX: an LSTM streaming checkpoint is not
    the reference's (ValueError), a seq2seq import of a streaming
    checkpoint finds no encoder (KeyError); the import needs a card unless
    the CPU is asked for."""
    bi, _ = _rt_ckpt(tmp_path, "bi.ckpt", bidir=True)
    assert ti.realtime_rnn_from_ckpt(bi, device="cpu").bidirectional
    lstm, _ = _rt_ckpt(tmp_path, "lstm.ckpt", cell="lstm")
    with pytest.raises(ValueError, match="GRU-based"):
        ti.realtime_rnn_from_ckpt(lstm, device="cpu")
    with pytest.raises(ValueError, match="GRU-based"):
        jti.realtime_rnn_from_ckpt(lstm)
    sd, _ = ti.load_lightning_ckpt(lstm)
    got = ti.lstm_params_from_torch(sd, "rnn.rnn", 1)
    want = jti.lstm_params_from_torch(sd, "rnn.rnn", 1)
    assert got.keys() == want.keys() == {"wi", "wh", "b"}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    got = ti.stacked_rnn_params_from_torch(sd, "rnn.rnn", 2, cell="lstm")
    want = jti.stacked_rnn_params_from_torch(sd, "rnn.rnn", 2, cell="lstm")
    assert got.keys() == want.keys()
    for layer in want:
        for k in want[layer]:
            np.testing.assert_array_equal(got[layer][k], want[layer][k])
    with pytest.raises(KeyError, match="encoder.rnn"):
        ti.seq2seq_from_ckpt(lstm, device="cpu")
    with pytest.raises(KeyError, match="encoder.rnn"):
        jti.seq2seq_from_ckpt(lstm)
    gru, _ = _rt_ckpt(tmp_path, "rt.ckpt")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ti.realtime_rnn_from_ckpt(gru)


# ------------------------------------------------------------- seq2seq --


def _s2s_ckpt(tmp_path, cell, C=3, NF=5, K=4, H=7, n_enc=2, n_dec=1,
              n_cls=6, enc_bidir=True, hp_extra=None):
    """A reference ``Seq2SeqRNN`` checkpoint (models.py:235-251) made from
    torch modules, the BatchNorm's running statistics off their init."""
    torch.manual_seed(7)
    Rnn = tnn.GRU if cell == "gru" else tnn.LSTM
    mods = {"temporal_conv.conv": tnn.Conv1d(C, NF, K),
            "temporal_conv.bn": tnn.BatchNorm1d(NF),
            "encoder.rnn": Rnn(NF, H, num_layers=n_enc, batch_first=True,
                               bidirectional=enc_bidir),
            "decoder.embedding": tnn.Embedding(n_cls + 1, H),
            "decoder.rnn": Rnn(H, H, num_layers=n_dec, batch_first=True),
            "decoder.fc_out": tnn.Linear(H, n_cls)}
    with torch.no_grad():
        mods["temporal_conv.bn"].running_mean.uniform_(-0.2, 0.2)
        mods["temporal_conv.bn"].running_var.uniform_(0.5, 1.5)
        mods["temporal_conv.bn"].weight.uniform_(0.5, 1.5)
        mods["temporal_conv.bn"].bias.uniform_(-0.2, 0.2)
    sd = {f"{p}.{k}": v for p, m in mods.items()
          for k, v in m.state_dict().items()}
    hp = dict(n_filters=NF, hidden_size=H, num_classes=n_cls,
              n_enc_layers=n_enc, n_dec_layers=n_dec, kernel_size=K,
              stride=1, cnn_dropout=0.3, rnn_dropout=0.3, model_type=cell,
              seq_length=3, activation=True, padding=0)
    hp.update(hp_extra or {})
    path = tmp_path / f"s2s_{cell}.ckpt"
    torch.save({"state_dict": sd, "hyper_parameters": hp}, path)
    return path


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_seq2seq_from_ckpt_matches_jax(tmp_path, cell):
    """One reference seq2seq checkpoint into both packages: the
    architecture, every weight and running statistic bit for bit
    (``seq2seq_params_from_flax`` of JAX's variables), and the eval-mode
    logits at teacher forcing 0 within 1e-5 of JAX's at full float32 (the
    JAX GRU on its scan path)."""
    path = _s2s_ckpt(tmp_path, cell)
    model = ti.seq2seq_from_ckpt(path, device="cpu")
    jm, jvars = jti.seq2seq_from_ckpt(path)
    assert jm.cell == cell and model.encoder.rnn.cell == cell
    assert model.n_dec_layers == jm.n_dec_layers == 1
    want = seq2seq_params_from_flax(
        jax.tree_util.tree_map(np.asarray, jvars["params"]),
        jax.tree_util.tree_map(np.asarray, jvars["batch_stats"]))
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    x = np.random.default_rng(2).normal(size=(4, 12, 3)).astype(np.float32)
    with torch.no_grad():
        logits = model.eval()(torch.from_numpy(x), None, 0.0).numpy()
    with jax.default_matmul_precision("highest"):
        logits_j = np.asarray(jax.jit(lambda v, x: jm.apply(
            v, x, None, 0.0, True))(jvars, jnp.asarray(x)))
    np.testing.assert_allclose(logits, logits_j, atol=LOGITS_ATOL)
    top2 = np.sort(logits_j[:, :-1], axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > 10 * LOGITS_ATOL


def test_seq2seq_from_ckpt_refusals(tmp_path):
    """A unidirectional encoder and a nonzero conv padding raise
    ``ValueError`` in both packages."""
    uni = _s2s_ckpt(tmp_path, "gru", enc_bidir=False)
    pad = _s2s_ckpt(tmp_path, "lstm", hp_extra=dict(padding=2))
    for path, match in ((uni, "bidirectional"), (pad, "padding")):
        with pytest.raises(ValueError, match=match):
            ti.seq2seq_from_ckpt(path, device="cpu")
        with pytest.raises(ValueError, match=match):
            jti.seq2seq_from_ckpt(path)


# ------------------------------------------------------- train-ctc init_ckpt --

SMALL = dict(context="patient", synth_T=40, synth_trials=54,
             synth_patients=3, seed=11, epochs=2, n_iter=2, dropout=0.0,
             lr=2e-2, batch_size=48, decay_steps=100, log_metrics=True)
CHANNELS = 64  # the synthetic target's


@pytest.fixture
def synth():
    """Both packages' synthetic caches filled with the same host arrays
    (tests/test_torch_ctc_driver.py's filler), emptied afterwards."""

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


def _history(out, it):
    path = os.path.join(os.path.dirname(out), "logs",
                        "S14_ptSpecific_ctcRnn", f"iter{it:03d}.csv")
    with open(path) as f:
        return [{k: float(v) for k, v in r.items()} for r in csv.DictReader(f)]


def test_train_ctc_init_ckpt_matches_jax(tmp_path, synth, jax_kernel_path):
    """train-ctc init_ckpt=: both drivers take the architecture from the
    checkpoint (into the caller's config) and warm-start every iteration
    from its weights; two iterations of two epochs at dropout 0 give
    every epoch's validation loss within 1e-3 relative and the test PER
    of each iteration within one edit of the test set's label total."""
    ckpt, _ = _rt_ckpt(tmp_path, "good.ckpt", C=CHANNELS, win=6, stride=2,
                       H=8, L=2, K=11, seed=4)
    cfg_j = JaxCfg(**SMALL, init_ckpt=str(ckpt),
                   out=str(tmp_path / "j" / "ctc.pkl"))
    cfg = TrainCTCConfig(**SMALL, init_ckpt=str(ckpt),
                         out=str(tmp_path / "t" / "ctc.pkl"))
    synth(cfg)
    pers_j = je.run_train_ctc(cfg_j, verbose=False)
    pers = te.run_train_ctc(cfg, verbose=False, device="cpu")
    for c in (cfg, cfg_j):
        assert (c.hidden, c.n_layers, c.win_size, c.stride) == (8, 2, 6, 2)
    one_edit = 100.0 / (11 * 3)  # 11 test rows of 3 labels
    assert pers.shape == pers_j.shape == (2,)
    assert np.abs(pers - pers_j).max() <= one_edit + 1e-9
    for it in range(2):
        h, hj = _history(cfg.out, it), _history(cfg_j.out, it)
        assert len(h) == len(hj) == 2
        for r, rj in zip(h, hj):
            np.testing.assert_allclose(r["loss"], rj["loss"],
                                       rtol=VAL_LOSS_RTOL)


def test_train_ctc_init_ckpt_rejects_mismatches(tmp_path, synth):
    """A checkpoint whose input width is not the data's, or whose class
    count is not 11, raises ValueError before training, as in JAX."""
    cfg = TrainCTCConfig(**SMALL, out="")
    synth(cfg)
    bad, _ = _rt_ckpt(tmp_path, "bad.ckpt", C=32, win=6, K=11)
    with pytest.raises(ValueError, match="input width"):
        te.run_train_ctc(TrainCTCConfig(**SMALL, out="", init_ckpt=str(bad)),
                         verbose=False, device="cpu")
    wrong_k, _ = _rt_ckpt(tmp_path, "k.ckpt", C=CHANNELS, win=6, K=9)
    with pytest.raises(ValueError, match="classes"):
        te.run_train_ctc(TrainCTCConfig(**SMALL, out="",
                                        init_ckpt=str(wrong_k)),
                         verbose=False, device="cpu")


def test_cli_train_ctc_init_ckpt(tmp_path, synth, capsys):
    """``cli.main train-ctc init_ckpt=<ckpt> device=cpu`` trains from the
    checkpoint and returns 0."""
    ckpt, _ = _rt_ckpt(tmp_path, "good.ckpt", C=CHANNELS, win=6, stride=2,
                       K=11)
    cfg = TrainCTCConfig(**{**SMALL, "n_iter": 1})
    synth(cfg)
    args = [f"{k}={v}" for k, v in SMALL.items() if k != "n_iter"]
    assert tmain.main(["train-ctc", "device=cpu", "n_iter=1", *args,
                       f"init_ckpt={ckpt}",
                       f"out={tmp_path / 'c' / 'ctc.pkl'}"]) == 0
    assert "iter 0 [patient]: test PER" in capsys.readouterr().out
