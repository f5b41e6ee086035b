"""The drivers with ``n_devices=2`` on the CPU against their one-device
runs, as tests/test_driver_mesh.py holds the JAX package's mesh paths
(the subsample sweeps' are tests/test_torch_subsample.py's
``test_n_devices_raises_before_any_work``).

Each driver given ``n_devices=2`` and no process group launches two gloo
ranks itself (``parallel.launch``) and returns rank 0's result. The
one-device runs happen in the test process at the ranks' thread count
(``torch_parallel_ranks.threads``). Both sides make their synthetic data
with the drivers' own generators, so no test-process patch is needed
where the ranks cannot see it. Tolerances are stated at each comparison.
"""

import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from cross_patient_speech_decoding_tpu_torch.cli import experiments as te
from cross_patient_speech_decoding_tpu_torch.cli.reproduce import (
    run_manifest,
)
from cross_patient_speech_decoding_tpu_torch.data.loaders import load_pkl
from cross_patient_speech_decoding_tpu_torch.utils.config import (
    ReproduceConfig,
    SVMDecodeConfig,
    TrainCTCConfig,
    TrainNNConfig,
    TrainSeq2SeqConfig,
    TuneCTCConfig,
)

torch.set_num_threads(2)

SVM = dict(synth_patients=3, synth_T=16, synth_trials=6, n_folds=4,
           n_iter=2, max_k=12, seed=3)


def _pair(run, cfg_cls, tmp_path, **kw):
    """(one-device result, two-rank result) of a driver on the CPU, the
    one-device run at the ranks' single thread."""
    with ranks.threads(1):
        one = run(cfg_cls(out=str(tmp_path / "one" / "r.pkl"), **kw),
                  verbose=False, device="cpu")
    two = run(cfg_cls(out=str(tmp_path / "two" / "r.pkl"), n_devices=2,
                      **kw), verbose=False, device="cpu")
    return one, two


def test_svm_decode_fixed_and_nested(tmp_path):
    """Fold sharding of the fixed-parameter decode (4 folds, fold_batch 3:
    each rank decodes its 2 folds in one batch) and of the nested search's
    outer folds: the accuracies of the one-device run (the ranks' batches
    give these folds the same sums here: atol 1e-6); the results pickle
    written once a run (n_iter records), by rank 0."""
    one, two = _pair(te.run_svm_decode, SVMDecodeConfig, tmp_path,
                     fold_batch=3, **SVM)
    np.testing.assert_allclose(two, one, atol=1e-6)
    assert len(load_pkl(tmp_path / "two" / "r.pkl")["accs"]) == SVM["n_iter"]
    nested = dict(SVM, n_iter=1, nested=True, nested_rounds=2,
                  nested_points=2, nested_inner=2)
    one, two = _pair(te.run_svm_decode, SVMDecodeConfig, tmp_path / "n",
                     **nested)
    assert two.shape == (1, SVM["n_folds"])
    np.testing.assert_allclose(two, one, atol=1e-6)
    assert len(load_pkl(tmp_path / "n" / "two" / "r.pkl")["accs"]) == 1


S2S = dict(synth_patients=3, synth_T=16, synth_trials=4, n_folds=4,
           n_iter=1, epochs=2, hidden=8, n_filters=4, kernel_size=4,
           seed=3)


def test_train_seq2seq_folds_bit_for_bit(tmp_path):
    """Fold sharding of the fold-parallel trainer (4 folds, fold_chunk 2:
    one fold a rank a chunk): every fold's accuracy bit for bit the
    one-device run's; the CSV and progress pickle written once."""
    one, two = _pair(te.run_train_seq2seq, TrainSeq2SeqConfig, tmp_path,
                     fold_chunk=2, **S2S)
    np.testing.assert_array_equal(two, one)
    prog = load_pkl(tmp_path / "two" / "r.progress.pkl")
    assert len(prog["accs"]) == 1
    np.testing.assert_array_equal(np.loadtxt(tmp_path / "two" / "r.pkl",
                                             delimiter=","), one)


def test_train_seq2seq_validations(tmp_path, monkeypatch):
    """JAX's checks, raised before any rank starts: fold_parallel is
    required, the world size must divide the fold chunk, rnn_impl
    'pallas' cannot take a mesh, and no more ranks than cards."""
    base = dict(n_iter=1, out=str(tmp_path / "x.csv"))
    with pytest.raises(ValueError, match="fold_parallel"):
        te.run_train_seq2seq(TrainSeq2SeqConfig(
            n_folds=4, n_devices=2, fold_parallel=False, **base),
            device="cpu")
    with pytest.raises(ValueError, match="divide"):
        te.run_train_seq2seq(TrainSeq2SeqConfig(n_folds=3, n_devices=2,
                                                **base), device="cpu")
    with pytest.raises(ValueError, match="divide"):
        te.run_train_seq2seq(TrainSeq2SeqConfig(
            n_folds=4, fold_chunk=3, n_devices=2, **base), device="cpu")
    with pytest.raises(ValueError, match="pallas"):
        te.run_train_seq2seq(TrainSeq2SeqConfig(
            n_folds=4, n_devices=2, rnn_impl="pallas", **base),
            device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="n_devices=2"):
        te.run_train_seq2seq(TrainSeq2SeqConfig(n_folds=4, n_devices=2,
                                                **base))
    assert not list(tmp_path.iterdir())


def test_train_ctc_data_parallel(tmp_path):
    """Data-parallel CTC training (batch 48: 24 rows a rank) at dropout
    0: the test PER within JAX's 1e-3 of the one-device run; the per-epoch
    log and the results pickle written once, by rank 0."""
    te._SYNTH_CTC_CACHE.clear()
    kw = dict(hidden=8, n_layers=2, win_size=6, stride=2, synth_T=40,
              synth_trials=54, synth_patients=3, seed=11, epochs=2,
              n_iter=1, dropout=0.0, lr=2e-2, batch_size=48,
              context="patient", log_metrics=True)
    one, two = _pair(te.run_train_ctc, TrainCTCConfig, tmp_path, **kw)
    te._SYNTH_CTC_CACHE.clear()
    assert np.isfinite(two).all()
    np.testing.assert_allclose(two, one, atol=1e-3)
    assert len(load_pkl(tmp_path / "two" / "r.pkl")["accs"]) == 1
    (log,) = (tmp_path / "two" / "logs").rglob("*.csv")
    assert len(log.read_text().splitlines()) == 1 + 2  # header, 2 epochs


def test_train_nn_data_parallel(tmp_path):
    """The data-parallel classifier step in the NN driver (transformer,
    no BatchNorm, dropout 0, batch 16 over 2 ranks): accuracies within
    JAX's 1e-3 of the one-device run, written once."""
    kw = dict(model="transformer", data="synthetic", n_iter=1, n_folds=2,
              epochs=2, d_model=8, n_heads=2, n_layers=1, dim_ff=16,
              dropout=0.0, max_k=8, batch_size=16, seed=2)
    one, two = _pair(te.run_train_nn, TrainNNConfig, tmp_path, **kw)
    np.testing.assert_allclose(two, one, atol=1e-3)
    assert len(load_pkl(tmp_path / "two" / "r.pkl")["accs"]) == 1


def test_tune_ctc_buckets_sharded(tmp_path):
    """Trial sharding of the tune buckets at small widths (the search
    space narrowed inside the ranks, ``torch_parallel_ranks.tune_small``):
    the same records as the one-device sweep (PERs atol 1e-6), the
    manifest written once (one line a trial and rung)."""
    kw = dict(synth_T=40, synth_trials=54, synth_patients=3, seed=5,
              n_trials=2, rungs="2", eta=2)
    with ranks.threads(1):
        one = ranks.tune_small(TuneCTCConfig(
            **kw, manifest=str(tmp_path / "one.jsonl")))
    from cross_patient_speech_decoding_tpu_torch import parallel

    two = parallel.launch(ranks.tune_small, 2, (TuneCTCConfig(
        **kw, n_devices=2, manifest=str(tmp_path / "two.jsonl")),),
        devices="cpu", timeout=300)
    assert [r["config"] for r in two] == [r["config"] for r in one]
    np.testing.assert_allclose([r["metric"] for r in two],
                               [r["metric"] for r in one], atol=1e-6)
    lines = (tmp_path / "two.jsonl").read_text().splitlines()
    assert len(lines) == len((tmp_path / "one.jsonl").read_text()
                             .splitlines()) == 2


def test_reproduce_runs_a_job_on_two_ranks(tmp_path):
    """``reproduce n_devices=2`` hands the width to the job, whose driver
    launches its ranks: the job's pickle holds the n_iter records once."""
    man = {"jobs": [{"command": "svm-decode", "overrides": {
        **SVM, "out": str(tmp_path / "svm.pkl")}}]}
    s = run_manifest(man, ReproduceConfig(n_devices=2), verbose=False,
                     device="cpu")
    assert s["ran"] == 1 and s["failed"] == []
    store = load_pkl(tmp_path / "svm.pkl")
    assert len(store["accs"]) == SVM["n_iter"]
    assert store["params"]["n_devices"] == 2


def test_cli_joins_a_torchrun_group(tmp_path, monkeypatch):
    """Under torchrun (RANK, WORLD_SIZE and a localhost rendezvous in the
    environment) ``cli.main`` joins that group instead of launching ranks,
    runs the driver in it and leaves no group behind: one rank on the CPU
    gives the one-device accuracies."""
    import socket

    import torch.distributed as dist

    from cross_patient_speech_decoding_tpu_torch.cli import main as tmain

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    args = [f"{k}={v}" for k, v in SVM.items()]
    out = tmp_path / "torchrun.pkl"
    with ranks.threads(1):
        assert tmain.main(["svm-decode", "device=cpu", "n_devices=1",
                           f"out={out}", *args]) == 0
        assert not dist.is_initialized()
        one = te.run_svm_decode(SVMDecodeConfig(
            out=str(tmp_path / "one.pkl"), **SVM), False, "cpu")
    np.testing.assert_allclose(np.stack(load_pkl(out)["accs"]), one,
                               atol=1e-6)
