"""The port's data and decode modules against the JAX package's, on the same
inputs made from a seed with numpy: labels, splits, the CTC file IO,
synthetic data, the tensor augmentations, prefix beam search and edit
distance, and the FIR filter.

Exact where both sides run the same numpy code (labels, splits, loaders,
the host synthetic generator, the Python beam search). Random draws come
from ``torch.Generator`` in the port and ``jax.random`` in JAX, so each
augmentation's apply is held to JAX's output on JAX's own draws, and the
draws themselves by statistics. Tolerances are stated at each check.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_patient_speech_decoding_tpu.data import loaders as jload
from cross_patient_speech_decoding_tpu.data import splits as jsplits
from cross_patient_speech_decoding_tpu.data import synthetic as jsyn
from cross_patient_speech_decoding_tpu.ops import augment as jaug
from cross_patient_speech_decoding_tpu.ops import ctc as jctc
from cross_patient_speech_decoding_tpu.ops import signal as jsig
from cross_patient_speech_decoding_tpu.utils import labels as jlab
from cross_patient_speech_decoding_tpu_torch.data import loaders, splits
from cross_patient_speech_decoding_tpu_torch.data import synthetic
from cross_patient_speech_decoding_tpu_torch.ops import augment, ctc, signal
from cross_patient_speech_decoding_tpu_torch.realtime import beam
from cross_patient_speech_decoding_tpu_torch.utils import labels

torch.set_num_threads(2)

# the FIR and filter_hg_bin against JAX: float32 products summed in
# another order over <= 9 taps
FILTER_RTOL = 1e-5
# an augmentation's apply on JAX's own draws: float32 gathers and
# interpolation, the same operations
AUG_ATOL = 1e-6
# prefix beam search's negative log likelihood, two double-precision
# computations of the same sums
NLL_ATOL = 1e-9


# ------------------------------------------------------------------ labels --


def test_labels_match_jax():
    rng = np.random.default_rng(0)
    seqs = rng.integers(0, 11, size=(40, 3))
    np.testing.assert_array_equal(labels.encode_label_sequences(seqs),
                                  jlab.encode_label_sequences(seqs))
    np.testing.assert_array_equal(labels.encode_label_sequences(seqs[:, 0]),
                                  jlab.encode_label_sequences(seqs[:, 0]))
    enc = labels.encode_label_sequences(seqs)
    for a, b in zip(labels.to_class_ids(enc), jlab.to_class_ids(enc)):
        np.testing.assert_array_equal(a, b)
    phon = rng.integers(1, 10, size=(30, 3))
    np.testing.assert_array_equal(labels.phon_to_artic(phon),
                                  jlab.phon_to_artic(phon))
    np.testing.assert_array_equal(labels.phon_seq_to_artic_str(phon),
                                  jlab.phon_seq_to_artic_str(phon))
    np.testing.assert_array_equal(labels.cv_structure(phon),
                                  jlab.cv_structure(phon))
    assert labels.PHON_DICT == jlab.PHON_DICT
    for n_sil in (0, 1):
        np.testing.assert_array_equal(
            labels.make_chance_labels(np.random.default_rng(3), 20, 5,
                                      n_sil=n_sil),
            jlab.make_chance_labels(np.random.default_rng(3), 20, 5,
                                    n_sil=n_sil))
    with pytest.raises(ValueError, match="0..10"):
        labels.encode_label_sequences(np.array([[1, 11]]))
    with pytest.raises(ValueError, match="outside the universe"):
        labels.to_class_ids(np.array([5]), np.array([1, 2]))


# ------------------------------------------------------------------ splits --


@pytest.mark.parametrize("n_folds", [3, 8])  # 8: the plain-KFold fallback
def test_splits_match_jax(n_folds):
    y = np.repeat(np.arange(5), 6)
    np.random.default_rng(1).shuffle(y)
    for got, want in zip(
            splits.stratified_kfold_masks(y, n_folds,
                                          np.random.default_rng(2)),
            jsplits.stratified_kfold_masks(y, n_folds,
                                           np.random.default_rng(2))):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(
            splits.repeated_stratified_kfold_masks(y, n_folds, 3, seed=4),
            jsplits.repeated_stratified_kfold_masks(y, n_folds, 3, seed=4)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(
            splits.train_val_test_masks(37, np.random.default_rng(5), 0.2,
                                        0.3),
            jsplits.train_val_test_masks(37, np.random.default_rng(5), 0.2,
                                         0.3)):
        np.testing.assert_array_equal(got, want)
    tr, _ = jsplits.stratified_kfold_masks(y, 3, np.random.default_rng(6))
    np.testing.assert_array_equal(
        splits.stratified_train_subsample_masks(tr, y, 0.5,
                                                np.random.default_rng(7)),
        jsplits.stratified_train_subsample_masks(tr, y, 0.5,
                                                 np.random.default_rng(7)))


# ----------------------------------------------------------------- loaders --


def _ctc_arrays(rng, n=6, T=41, C=5, L=3):
    X = rng.normal(size=(n, T, C)).astype(np.float32)
    y = rng.integers(1, 10, size=(n, L)).astype(np.int64)
    return X, y


def test_ctc_h5_reads_the_same_bytes_both_ways(tmp_path):
    """Files written by either package are read equal by both, with every
    flag of load_ctc_h5 (crop, sil tokens, z-score keys, train only, load
    all)."""
    rng = np.random.default_rng(0)
    X, y = _ctc_arrays(rng)
    Xt, yt = _ctc_arrays(rng, n=4)
    f_j, f_t = tmp_path / "j.h5", tmp_path / "t.h5"
    for zs in (False, True):
        jload.save_ctc_h5(f_j, "S1", X, y, Xt, yt, zscore=zs)
        loaders.save_ctc_h5(f_t, "S1", X, y, Xt, yt, zscore=zs)
    loaders.save_ctc_h5(f_t, "S2", X[:3], y[:3])
    jload.save_ctc_h5(f_j, "S2", X[:3], y[:3])
    cases = [dict(), dict(zscore=True), dict(n_sil=2),
             dict(tw_select=(1.0, 2.5), tw_orig=(0.0, 4.0)),
             dict(load_all=True, n_sil=1)]
    for f in (f_j, f_t):
        for kw in cases:
            for got, want in zip(loaders.load_ctc_h5(f, "S1", **kw),
                                 jload.load_ctc_h5(f, "S1", **kw)):
                np.testing.assert_array_equal(got, want)
        got = loaders.load_ctc_h5(f, "S2", only_train=True)
        want = jload.load_ctc_h5(f, "S2", only_train=True)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[2] is None and want[2] is None
    with pytest.raises(ValueError, match="mutually exclusive"):
        loaders.load_ctc_h5(f_t, "S1", only_train=True, load_all=True)


def test_xforms_hparams_and_results_match_jax(tmp_path, capsys):
    rng = np.random.default_rng(1)
    comp = rng.normal(size=(4, 5))
    cca = rng.normal(size=(4, 4))
    jload.save_xforms_h5(tmp_path / "pca.h5", pca={"S1": comp},
                         cca={("S2", "S1"): cca})
    W = loaders.load_pca_xform(tmp_path / "pca.h5", "S1")
    np.testing.assert_array_equal(W, jload.load_pca_xform(
        tmp_path / "pca.h5", "S1"))
    M = loaders.load_cca_xform(tmp_path / "pca.h5", "S1", "S2")
    np.testing.assert_array_equal(M, jload.load_cca_xform(
        tmp_path / "pca.h5", "S1", "S2"))
    X, _ = _ctc_arrays(rng)
    for m in (None, M):
        np.testing.assert_array_equal(loaders.apply_latent_xform(X, W, m),
                                      jload.apply_latent_xform(X, W, m))

    defaults = {"learning_rate": 1e-3, "hidden_size": 128, "dropout": 0.3}
    jload.save_tuned_hparams(tmp_path / "hp", "S1", "aligned",
                             {"learning_rate": 5e-4, "hidden_size": 64})
    for ctx in ("aligned", "chance"):  # chance: no file, the defaults
        assert loaders.load_tuned_hparams(tmp_path / "hp", "S1", ctx,
                                          defaults) == \
            jload.load_tuned_hparams(tmp_path / "hp", "S1", ctx, defaults)
    assert "not found" in capsys.readouterr().out

    pers = np.array([40.0, 37.5])
    logits = rng.normal(size=(2, 3, 4, 11)).astype(np.float32)
    hp = {"hidden_size": 8, "dropout": 0.0}
    loaders.save_ctc_results_h5(tmp_path / "r.h5", pers, logits,
                                labels.PHON_DICT, hp)
    got = jload.load_ctc_results_h5(tmp_path / "r.h5")
    np.testing.assert_array_equal(got["phoneme_error_rate"], pers)
    np.testing.assert_array_equal(got["logits"], logits)
    assert got["phon_dict"] == jlab.PHON_DICT
    assert got["model_hparams"] == hp


def test_results_pickles_match_jax(tmp_path):
    """append_results_pkl writes the same store in both packages, and each
    reads the other's."""
    params = {"context": "aligned", "n_iter": 3}
    for mod, name in ((loaders, "t.pkl"), (jload, "j.pkl")):
        mod.append_results_pkl(tmp_path / name, np.array([12.5]), params,
                               extra={"logits": np.ones(2)})
        mod.append_results_pkl(tmp_path / name, np.array([10.0]), params)
    t = jload.load_pkl(tmp_path / "t.pkl")
    j = loaders.load_pkl(tmp_path / "j.pkl")
    assert pickle.dumps(t) == pickle.dumps(j)
    loaders.save_pkl({"a": 1}, tmp_path / "s.pkl")
    assert jload.load_pkl(tmp_path / "s.pkl") == {"a": 1}


# --------------------------------------------------------------- synthetic --


def test_host_synthetic_is_bitwise_jax():
    kw = dict(seed=5, n_patients=3, n_classes=9, trials_per_class=3, T=20,
              channels=(12, 16, 9), latent_dim=4, noise=0.3)
    a, b = synthetic.make_synthetic_patients(**kw), \
        jsyn.make_synthetic_patients(**kw)
    for field in ("X", "y_seq", "y_first", "class_ids", "mixings"):
        for x, y in zip(getattr(a, field), getattr(b, field)):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.latent, b.latent)
    np.testing.assert_array_equal(a.class_universe, b.class_universe)
    # channel counts drawn from the rng
    c = synthetic.make_synthetic_patients(seed=2, channels=20)
    d = jsyn.make_synthetic_patients(seed=2, channels=20)
    assert [x.shape for x in c.X] == [x.shape for x in d.X]


def test_device_synthetic_host_parts_and_draw_statistics():
    """The device twin's host part (trajectories, sequences, class rows,
    channel counts) equals JAX's device twin's; the mixing matrices are
    N(0, 1/latent_dim) and the noise N(0, noise^2) (each mean within 5
    standard errors of 0, each variance within 5 % of its value)."""
    kw = dict(seed=1, n_patients=3, n_classes=27, trials_per_class=4, T=60,
              channels=(40, 56, 48), latent_dim=6, noise=0.5, seq_len=3)
    got = synthetic.make_synthetic_patients_device(device="cpu", **kw)
    want = jsyn.make_synthetic_patients_device(**kw)
    np.testing.assert_array_equal(got.latent, want.latent)
    np.testing.assert_array_equal(got.class_universe, want.class_universe)
    for field in ("y_seq", "y_first", "class_ids"):
        for x, y in zip(getattr(got, field), getattr(want, field)):
            np.testing.assert_array_equal(x, y)
    assert [tuple(x.shape) for x in got.X] == [x.shape for x in want.X]
    assert all(x.dtype == torch.float32 for x in got.X)

    mix = torch.cat([m.reshape(-1) for m in got.mixings]).double()
    resid = torch.cat([
        (x - torch.from_numpy(got.latent)[torch.from_numpy(
            np.searchsorted(got.class_universe,
                            labels.encode_label_sequences(y)))] @ m
         ).reshape(-1)
        for x, y, m in zip(got.X, got.y_seq, got.mixings)]).double()
    for draws, var in ((mix, 1 / 6), (resid, 0.25)):
        n = draws.numel()
        assert abs(float(draws.mean())) < 5 * (var / n) ** 0.5
        assert abs(float(draws.var()) / var - 1) < 0.05
    # another seed, other draws; the same seed, the same tensors
    again = synthetic.make_synthetic_patients_device(device="cpu", **kw)
    assert torch.equal(again.X[0], got.X[0])
    other = synthetic.make_synthetic_patients_device(
        device="cpu", **{**kw, "seed": 2})
    assert not torch.equal(other.mixings[0], got.mixings[0])


# ------------------------------------------------------------ augmentation --


def _x(seed=0, N=64, T=50, C=3):
    return np.random.default_rng(seed).normal(size=(N, T, C)).astype(
        np.float32)


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


AUGS = ("time_warping", "time_masking", "time_shifting", "noise_jitter",
        "scaling")


@pytest.mark.parametrize("name", AUGS)
def test_augmentation_apply_on_jax_draws(name):
    x = _x()
    key = jax.random.key(7)
    want = np.asarray(getattr(jaug, name)(key, jnp.asarray(x)))
    d = _jax_draws(name, key, x)
    d = (tuple(torch.from_numpy(np.array(a)) for a in d)
         if isinstance(d, tuple) else torch.from_numpy(np.array(d)))
    got = getattr(augment, f"{name}_apply")(torch.from_numpy(x), d)
    np.testing.assert_allclose(got.numpy(), want, atol=AUG_ATOL, rtol=0)
    # the full transform draws from the generator, keeps shape and dtype
    full = getattr(augment, name)(torch.Generator().manual_seed(1),
                                  torch.from_numpy(x))
    assert full.shape == x.shape and full.dtype == torch.float32


def test_augmentation_draw_statistics():
    """Each draw's range and moments are those of JAX's draw: uniform warp
    factors in [0.8, 1.2) (mean 1, var 0.04/3), widths in [0, 10] and
    starts in [0, T - 10), shifts in [-10, 10], all values taken; unit
    normals for noise and scaling. Moments within 5 standard errors."""
    gen = torch.Generator().manual_seed(0)
    x = torch.zeros(4000, 50, 2)
    f = augment.time_warping_draw(gen, x).double()
    assert 0.8 <= float(f.min()) and float(f.max()) < 1.2
    assert abs(float(f.mean()) - 1.0) < 5 * (0.04 / 3 / 4000) ** 0.5
    w, s = augment.time_masking_draw(gen, x)
    assert set(w.tolist()) == set(range(11))
    assert set(s.tolist()) == set(range(40))
    sh = augment.time_shifting_draw(gen, x)
    assert set(sh.tolist()) == set(range(-10, 11))
    assert abs(float(sh.double().mean())) < 5 * (110 / 12 / 4000) ** 0.5
    for draws in (augment.noise_jitter_draw(gen, x).double(),
                  augment.scaling_draw(gen, x).double()):
        n = draws.numel()
        assert abs(float(draws.mean())) < 5 / n ** 0.5
        assert abs(float(draws.std()) - 1) < 5 * (0.5 / n) ** 0.5
    # masking and scaling: what the apply does with its draws
    y = augment.time_masking_apply(torch.ones(2, 12, 1), (
        torch.tensor([3, 0]), torch.tensor([2, 5])))
    assert y[0, :, 0].tolist() == [1, 1, 0, 0, 0] + [1] * 7
    assert bool((y[1] == 1).all())


# ------------------------------------------------------------- beam search --


def _log_probs(seed, T=30, V=6):
    rng = np.random.default_rng(seed)
    p = rng.dirichlet(np.ones(V) * 0.5, size=T)
    # float32-representable values: the native search reads float32
    return np.log(p).astype(np.float32).astype(np.float64)


@pytest.mark.parametrize("seed,beam_size", [(0, 1), (1, 8), (2, 25)])
def test_prefix_beam_search_matches_jax_and_native(seed, beam_size):
    """Python beam search against JAX's (the same code: equal prefixes,
    NLL within 1e-9) and the native search against both (equal prefixes,
    NLL within 1e-9: both compute in double from the same float32
    values)."""
    lp = _log_probs(seed)
    seq, nll = ctc.prefix_beam_search(lp, beam_size)
    seq_j, nll_j = jctc.prefix_beam_search(lp, beam_size)
    assert seq == seq_j and len(seq) > 0
    assert abs(nll - nll_j) <= NLL_ATOL
    assert beam.native_available()
    seq_n, nll_n = beam.prefix_beam_search(lp.astype(np.float32), beam_size)
    assert seq_n == seq
    assert abs(nll_n - nll) <= NLL_ATOL * max(1.0, abs(nll))


def test_edit_distance_native_python_and_jax():
    from cross_patient_speech_decoding_tpu.realtime.beam import _py_edit

    rng = np.random.default_rng(4)
    B, P, L = 40, 9, 5
    preds = rng.integers(0, 6, size=(B, P))
    targets = rng.integers(1, 6, size=(B, L))
    pl = rng.integers(0, P + 1, size=B)
    tl = rng.integers(1, L + 1, size=B)
    got = beam.edit_distance_batch(preds, pl, targets, tl)
    want = [_py_edit(preds[b, :pl[b]], targets[b, :tl[b]]) for b in range(B)]
    np.testing.assert_array_equal(got, want)
    assert [beam._py_edit(preds[b, :pl[b]], targets[b, :tl[b]])
            for b in range(B)] == want
    with pytest.raises(ValueError, match="outside"):
        beam.edit_distance_batch(preds, pl + P, targets, tl)


def test_native_library_builds_outside_native_dir():
    """The library lands in the port's git-ignored build directory under a
    name keyed by the source and flags; native/ is only read."""
    path = beam.library_path()
    assert path.parent == beam.BUILD_DIR
    assert path.name.startswith("libcpsd_native_")
    assert beam.SOURCE.name == "beam.cpp" and beam.SOURCE.is_file()
    assert beam.build() == path and path.is_file()


# -------------------------------------------------------------------- FIR --


def _filter_inputs(seed=0, C=6, T=40, bands=3, taps=9):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(C, T)).astype(np.float32)
    fir = rng.normal(size=(bands, taps)).astype(np.float32) / taps
    import scipy.signal as sps

    b, a = zip(*(sps.butter(2, (lo, lo + 0.1), btype="band")
                 for lo in (0.1, 0.3, 0.5)))
    return data, fir, np.asarray(b), np.asarray(a)


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


def test_fir_and_filter_hg_bin_match_jax():
    """fir_filter and each route of filter_hg_bin (FIR; IIR as (b, a) and
    as the stacked (bands, taps, 2) layout; steady-state and carried
    state) within 1e-5 of the largest output."""
    data, fir, b, a = _filter_inputs()
    dt = torch.from_numpy(data)
    _close(signal.fir_filter(dt, torch.from_numpy(fir)),
           jsig.fir_filter(jnp.asarray(data), jnp.asarray(fir)), FILTER_RTOL)
    out, st = signal.filter_hg_bin(dt, fir)
    out_j, st_j = jsig.filter_hg_bin(jnp.asarray(data), fir)
    assert st is None and st_j is None
    _close(out, out_j, FILTER_RTOL)
    stacked = np.stack([a, b], axis=-1).astype(np.float32)
    for coefs in ((b.astype(np.float32), a.astype(np.float32)), stacked):
        out, zf = signal.filter_hg_bin(dt, coefs)
        out_j, zf_j = jsig.filter_hg_bin(jnp.asarray(data), coefs)
        _close(out, out_j, FILTER_RTOL)
        _close(zf, zf_j, FILTER_RTOL)
        # carried state into the next chunk
        out2, _ = signal.filter_hg_bin(dt, coefs, zf)
        out2_j, _ = jsig.filter_hg_bin(jnp.asarray(data), coefs, zf_j)
        _close(out2, out2_j, FILTER_RTOL)
    with pytest.raises(ValueError, match="2-D"):
        signal.filter_hg_bin(dt, np.zeros(3))
