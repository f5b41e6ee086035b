"""The port's classical-decode driver (``run_svm_decode``, ``cpsd
svm-decode``) against the JAX package's, on the CPU at small sizes.

Both drivers get the same data: their synthetic generators are replaced
by the JAX package's host generator (the port's device twin draws from a
``torch.Generator``, JAX's from ``jax.random``), and file-backed runs read
one decoding-data pickle written in ``tmp_path``. Splits, chance
permutations and subsamples are numpy draws in the same order on both
sides, so the results files are compared key by key: accuracies within
1e-6, ``y_true``, ``y_pred`` and ``wrong_trs`` equal (sepAlign at these
sizes keeps every test trial's top two scores far apart; the margin-aware
comparison is tests/test_torch_decoders.py's).
"""

import pickle

import numpy as np
import pytest
import torch

from cross_patient_speech_decoding_tpu.cli import experiments as je
from cross_patient_speech_decoding_tpu.data import loaders as jload
from cross_patient_speech_decoding_tpu.data import synthetic as jsyn
from cross_patient_speech_decoding_tpu.utils.config import (
    SVMDecodeConfig as JaxCfg,
)
from cross_patient_speech_decoding_tpu_torch.cli import experiments as te
from cross_patient_speech_decoding_tpu_torch.cli import main as tmain
from cross_patient_speech_decoding_tpu_torch.data import loaders
from cross_patient_speech_decoding_tpu_torch.utils.config import (
    SVMDecodeConfig,
)

torch.set_num_threads(2)

ACC_ATOL = 1e-6
SMALL = dict(synth_patients=3, synth_T=16, synth_trials=6, n_folds=4,
             n_iter=2, max_k=12, seed=3)


@pytest.fixture
def host_synth(monkeypatch):
    """Both drivers' synthetic data from the JAX package's host generator
    (the port's own host generator is bit for bit the same)."""
    monkeypatch.setattr(je, "make_synthetic_patients_device",
                        lambda **kw: jsyn.make_synthetic_patients(**kw))
    monkeypatch.setattr(te, "make_synthetic_patients_device",
                        lambda device=None, **kw:
                        jsyn.make_synthetic_patients(**kw))


def _cfgs(tmp_path, **kw):
    kw = {**SMALL, **kw}
    return (JaxCfg(out=str(tmp_path / "j" / "svm.pkl"), **kw),
            SVMDecodeConfig(out=str(tmp_path / "t" / "svm.pkl"), **kw))


def _same_store(path, path_j):
    got, want = loaders.load_pkl(path), jload.load_pkl(path_j)
    assert len(got["accs"]) == len(want["accs"])
    for a, a_j in zip(got["accs"], want["accs"]):
        np.testing.assert_allclose(a, a_j, atol=ACC_ATOL)
    assert len(got.get("extra", [])) == len(want.get("extra", []))
    for x, x_j in zip(got.get("extra", []), want.get("extra", [])):
        assert set(x) == set(x_j)
        for k in x_j:
            np.testing.assert_array_equal(np.asarray(x[k]),
                                          np.asarray(x_j[k]), err_msg=k)
    assert got["params"] == {**want["params"], "out": got["params"]["out"]}


@pytest.mark.parametrize("case", [
    {},
    {"chance": True},
    {"trial_subsample": 0.6},
    {"pool_train": False},
    {"pooled_pts": "synthetic2", "tar_in_train": False},
    {"random_data": True, "strategy": "sep_dimred", "save_preds": False},
])
def test_run_svm_decode_matches_jax(tmp_path, host_synth, case):
    """The results pickle of two iterations as JAX's: accuracies,
    y_true, y_pred and wrong_trs of every iteration, and the params."""
    cfg_j, cfg = _cfgs(tmp_path, **case)
    if case.get("strategy") == "sep_dimred":
        # random cross data has no structure to carry; sepDimRed's latent
        # signs differ between the packages (the port fixes them), so only
        # the target's rows (pool_train=False) keep the runs comparable
        cfg_j.pool_train = cfg.pool_train = False
    accs_j = je.run_svm_decode(cfg_j, verbose=False)
    accs = te.run_svm_decode(cfg, verbose=False, device="cpu")
    assert accs.shape == accs_j.shape == (2, 4)
    np.testing.assert_allclose(accs, accs_j, atol=ACC_ATOL)
    _same_store(cfg.out, cfg_j.out)


def test_iter_batch_resume_and_cross_package_resume(tmp_path, host_synth,
                                                    capsys):
    """iter_batch=2 equals iter_batch=1 bit for bit; a run stopped after
    one iteration and resumed equals the uninterrupted run; a results file
    written by the JAX driver resumes in the port with no work left."""
    base = dict(SMALL, n_iter=3)
    one = te.run_svm_decode(SVMDecodeConfig(out=str(tmp_path / "a.pkl"),
                                            **base), False, "cpu")
    two = te.run_svm_decode(SVMDecodeConfig(out=str(tmp_path / "b.pkl"),
                                            iter_batch=2, **base),
                            False, "cpu")
    np.testing.assert_array_equal(two, one)
    part = str(tmp_path / "c.pkl")
    te.run_svm_decode(SVMDecodeConfig(out=part, **dict(base, n_iter=1)),
                      False, "cpu")
    resumed = te.run_svm_decode(SVMDecodeConfig(out=part, **base), True,
                                "cpu")
    assert "resuming: 1/3" in capsys.readouterr().out
    np.testing.assert_array_equal(resumed, one)
    for a, b in zip(loaders.load_pkl(part)["extra"],
                    loaders.load_pkl(str(tmp_path / "a.pkl"))["extra"]):
        np.testing.assert_array_equal(a["y_pred"], b["y_pred"])

    cfg_j, cfg = _cfgs(tmp_path)
    accs_j = je.run_svm_decode(cfg_j, verbose=False)
    cfg.out = cfg_j.out
    again = te.run_svm_decode(cfg, verbose=True, device="cpu")
    assert "resuming: 2/2" in capsys.readouterr().out
    np.testing.assert_array_equal(again, accs_j)


def test_nested_driver_matches_jax(tmp_path, host_synth):
    """nested=true: two TPE rounds a fold, the best hyperparameters per
    outer fold persisted beside the predictions, as JAX's."""
    cfg_j, cfg = _cfgs(tmp_path, nested=True, nested_rounds=2,
                       nested_points=2, nested_inner=2, n_iter=1)
    accs_j = je.run_svm_decode(cfg_j, verbose=False)
    accs = te.run_svm_decode(cfg, verbose=False, device="cpu")
    np.testing.assert_allclose(accs, accs_j, atol=ACC_ATOL)
    _same_store(cfg.out, cfg_j.out)
    assert {"n_comp", "lam", "gamma_scale"} <= set(
        loaders.load_pkl(cfg.out)["extra"][0])


def test_cli_svm_decode_runs_in_process(tmp_path, host_synth, capsys):
    """``cli.main svm-decode device=cpu`` runs the driver with key=value
    overrides; device= is not a config field."""
    out = tmp_path / "svm.pkl"
    args = ["svm-decode", "device=cpu", "synth_patients=3", "synth_T=16",
            "n_iter=2", "n_folds=4", f"out={out}"]
    assert tmain.main(args) == 0
    text = capsys.readouterr().out
    assert "iter 1: balanced acc" in text
    store = loaders.load_pkl(out)
    assert len(store["accs"]) == 2 and "device" not in store["params"]
    assert tmain.main(args) == 0
    assert "resuming: 2/2" in capsys.readouterr().out


def test_unported_options_raise(tmp_path):
    """n_devices=2 shards the folds over two gloo ranks that the driver
    launches, a surrogate control with it (the mode-shuffle surrogates
    drawn the same on every rank): the one-device accuracies (atol 1e-6),
    the results pickle written once, by rank 0."""
    import torch_parallel_ranks as ranks

    kw = dict(SMALL, n_iter=1, surrogate="shuffle")
    with ranks.threads(1):
        one = te.run_svm_decode(SVMDecodeConfig(
            out=str(tmp_path / "one.pkl"), **kw), False, "cpu")
    two = te.run_svm_decode(SVMDecodeConfig(
        n_devices=2, out=str(tmp_path / "two.pkl"), **kw), False, "cpu")
    np.testing.assert_allclose(two, one, atol=1e-6)
    assert len(loaders.load_pkl(tmp_path / "two.pkl")["accs"]) == 1


def test_svm_decode_defaults_to_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        te.run_svm_decode(SVMDecodeConfig(out=str(tmp_path / "x.pkl")))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        te.patients_from_config("synthetic", "S14", T=4)


def _decoding_dict(seed=0):
    """A ``pt_decoding_data`` dict in the reference's layout: three
    patients, collapsed arrays and phoneme position 1, phoneme labels
    1-9, full sequences of 3."""
    rng = np.random.default_rng(seed)
    ds = jsyn.make_synthetic_patients(seed=seed, n_patients=3, n_classes=9,
                                      trials_per_class=4, T=16,
                                      channels=(20, 24, 18), latent_dim=5,
                                      noise=0.5)
    names = ["S14", "S26", "S33"]
    out = {}
    for p, name in enumerate(names):
        X, seq = ds.X[p].astype(np.float32), ds.y_seq[p]
        n = len(X)
        out[name] = {
            "X_collapsed": np.concatenate([X, X[:, ::-1], X * 0.5]),
            "y_phon_collapsed": np.concatenate([seq[:, 0], seq[:, 1],
                                                seq[:, 2]]),
            "y_full_phon": seq,
            "X1": X,
            "y1": seq[:, 0],
            "pre_pts": [m for m in names if m != name],
        }
        assert out[name]["y_phon_collapsed"].shape == (3 * n,)
    del rng
    return out


@pytest.mark.parametrize("p_ind,lab_type", [(-1, "phon"), (1, "artic")])
def test_decoding_data_file_matches_jax(tmp_path, p_ind, lab_type):
    """A decoding-data pickle: ``decoding_data_from_dict`` returns JAX's
    arrays, and ``run_svm_decode`` on the file gives JAX's results."""
    d = _decoding_dict()
    got = loaders.decoding_data_from_dict(d, "S14", p_ind, lab_type)
    want = jload.decoding_data_from_dict(d, "S14", p_ind, lab_type)
    for g, w in zip([got[0]] + got[1], [want[0]] + want[1]):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    path = tmp_path / "pt_decoding_data.pkl"
    with open(path, "wb") as f:
        pickle.dump(d, f)
    kw = dict(data=str(path), target_pt="S14", p_ind=p_ind,
              lab_type=lab_type, n_iter=1, n_folds=3, max_k=8, seed=1)
    cfg_j = JaxCfg(out=str(tmp_path / "j.pkl"), **kw)
    cfg = SVMDecodeConfig(out=str(tmp_path / "t.pkl"), **kw)
    np.testing.assert_allclose(
        te.run_svm_decode(cfg, verbose=False, device="cpu"),
        je.run_svm_decode(cfg_j, verbose=False), atol=ACC_ATOL)
    _same_store(cfg.out, cfg_j.out)
