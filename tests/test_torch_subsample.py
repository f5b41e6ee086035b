"""The port's subsample sweeps (``cpsd subsample-{trials,grid,spatial,
pitch}``), its electrode-subsampling module and its ``.mat``/geometry
readers against the JAX package's, on the CPU at small sizes.

Both packages read the same files: a ``pt_decoding_data`` pickle and a
``pt_savg_data`` pickle of four paper patients (the JAX package's host
synthetic generator, 9 classes x 6 trials, T=16) and the patients'
``{pt}_channelMap.mat``/``{pt}_sigChannel.mat`` geometry. Synthetic-data
sweeps replace both drivers' device generators with that host generator.

Tolerances: the index functions, the geometry readers, the sweeps' drawn
indices and fold masks are compared bit for bit. A decode's fold
accuracies are held by the decided-trial rule of
tests/test_torch_decoders.py: within 1e-6 plus the balanced-accuracy
weight of the test trials whose top two decision scores (the port's)
lie within 1e-4 of their magnitude; a sweep point's accuracy, the mean
of its folds', within 1e-6 plus the mean of those weights. sep_align
needs no PCA signs from JAX: the CCA absorbs a source's, and the RBF
head sees a target column's sign on every pooled row alike.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cross_patient_speech_decoding_tpu.cli import experiments as je
from cross_patient_speech_decoding_tpu.cli import subsample_experiments as js
from cross_patient_speech_decoding_tpu.data import loaders as jload
from cross_patient_speech_decoding_tpu.data import subsample as jsub
from cross_patient_speech_decoding_tpu.data import synthetic as jsyn
from cross_patient_speech_decoding_tpu.decoders import pooled as jpool
from cross_patient_speech_decoding_tpu_torch.cli import experiments as te
from cross_patient_speech_decoding_tpu_torch.cli import main as tmain
from cross_patient_speech_decoding_tpu_torch.cli import (
    subsample_experiments as ts,
)
from cross_patient_speech_decoding_tpu_torch.data import loaders as tload
from cross_patient_speech_decoding_tpu_torch.data import subsample as tsub
from cross_patient_speech_decoding_tpu_torch.decoders import pooled as tpool
from cross_patient_speech_decoding_tpu_torch.ops import classifiers as tcl

torch.set_num_threads(2)

ACC_ATOL = 1e-6
DECIDED = 1e-4
PTS = ("S14", "S22", "S33", "S58")
CHANS = {"S14": 14, "S22": 12, "S33": 16, "S58": 10}
T = 16
TPC = 6  # trials a class: three blocks of two (the collapsed layout)


# ------------------------------------------------------------- fixtures ----

def _maps(rng):
    """Per-patient (channel map, significant channels). S22's map is 24
    rows long with NaN edge rows (trimmed on load, window transposed)."""
    geo = {}
    m = np.arange(1, 25, dtype=float).reshape(4, 6)
    m[0, 0] = m[-1, -1] = np.nan
    geo["S14"] = m
    m = np.full((24, 4), np.nan)
    m[1:-1] = np.arange(1, 89, dtype=float).reshape(22, 4)
    geo["S22"] = m
    m = np.arange(1, 31, dtype=float).reshape(5, 6)
    m[0, -1] = np.nan
    geo["S33"] = m
    geo["S58"] = np.arange(1, 25, dtype=float).reshape(6, 4)
    return {pt: (m, np.sort(rng.choice(m[~np.isnan(m)].astype(int),
                                       CHANS[pt], replace=False)))
            for pt, m in geo.items()}


def reference_entry(X, y_seq, class_ids, pre_pts):
    """One patient's ``pt_decoding_data`` entry in the reference layout
    (alignment_utils.py:127-184): ``X1..X3`` three blocks of trials,
    ``X_collapsed`` their concatenation, ``y_full_phon`` the sequences of
    one block (tiled x3 by the reader). Each block holds a third of every
    class's trials in one class order, so the tiled sequences are each
    collapsed trial's own; the labels are the sequences' first phonemes
    (the synthetic data's class target)."""
    per = np.bincount(class_ids) // 3
    blocks = [np.concatenate([np.where(class_ids == c)[0][b * n:(b + 1) * n]
                              for c, n in enumerate(per)])
              for b in range(3)]
    d = {"y_full_phon": y_seq[blocks[0]], "pre_pts": list(pre_pts)}
    for p, idx in enumerate(blocks, 1):
        d[f"X{p}"] = np.asarray(X[idx], np.float32)
        d[f"y{p}"] = y_seq[idx, 0]
    d["X_collapsed"] = np.concatenate([d[f"X{p}"] for p in (1, 2, 3)])
    d["y_phon_collapsed"] = np.concatenate([d[f"y{p}"] for p in (1, 2, 3)])
    return d


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Geometry dir, decoding pickle and savg pickle (cs_2x2, cs_3x3 from
    the port's ``spatial_avg_data`` on each patient's loaded geometry)."""
    root = tmp_path_factory.mktemp("subsample")
    geo = _maps(np.random.default_rng(42))
    for pt, (cmap, sig) in geo.items():
        tload.save_geometry_mat(root, pt, cmap, sig)
    ds = jsyn.make_synthetic_patients(
        seed=3, n_patients=len(PTS), n_classes=9, trials_per_class=TPC, T=T,
        channels=tuple(CHANS[pt] for pt in PTS), latent_dim=6, noise=1.5)
    data, savg = {}, {}
    for i, pt in enumerate(PTS):
        d = reference_entry(ds.X[i], ds.y_seq[i], ds.class_ids[i],
                            [p for p in PTS if p != pt])
        data[pt] = d
        cmap, _ = tload.load_channel_map(root, pt)
        sig = tload.load_sig_channels(root, pt)
        savg[pt] = {**d, "X_collapsed": {
            f"cs_{c}x{c}": tsub.spatial_avg_data(
                d["X_collapsed"], tsub.spatial_avg_groups(cmap, c),
                channel_ids=sig).astype(np.float32)
            for c in (2, 3)}}
    tload.save_pkl(data, root / "pt_decoding_data.pkl")
    tload.save_pkl(savg, root / "pt_savg_data.pkl")
    return {"dir": str(root), "pkl": str(root / "pt_decoding_data.pkl"),
            "savg": str(root / "pt_savg_data.pkl")}


@pytest.fixture
def host_synth(monkeypatch):
    """Both drivers' synthetic data from the JAX package's host generator
    (tests/test_torch_svm_driver.py's fixture)."""
    monkeypatch.setattr(je, "make_synthetic_patients_device",
                        lambda **kw: jsyn.make_synthetic_patients(**kw))
    monkeypatch.setattr(te, "make_synthetic_patients_device",
                        lambda device=None, **kw:
                        jsyn.make_synthetic_patients(**kw))


class _Record:
    """What one package's sweep drew and decoded: fold masks, trial and
    channel indices, and per decode the fold accuracies, test masks and
    target labels (and, for the port, the decision scores)."""

    def __init__(self):
        self.masks, self.trials, self.channels, self.decodes = [], [], [], []
        self.scores = []


@pytest.fixture
def recorded(monkeypatch):
    """Recorders installed in both sweep modules: (jax, port)."""
    jr, tr = _Record(), _Record()
    for mod, rec in ((js, jr), (ts, tr)):
        split, take = mod.stratified_kfold_masks, mod.trial_subsample_indices
        gather = mod._gather_channels

        def masks(y, n, rng, _f=split, _r=rec):
            out = _f(y, n, rng)
            _r.masks.append(out)
            return out

        def trials(y, k, rng, _f=take, _r=rec):
            out = _f(y, k, rng)
            _r.trials.append(out)
            return out

        def channels(pt, idx, _f=gather, _r=rec):
            _r.channels.append(np.asarray(idx))
            return _f(pt, idx)

        monkeypatch.setattr(mod, "stratified_kfold_masks", masks)
        monkeypatch.setattr(mod, "trial_subsample_indices", trials)
        monkeypatch.setattr(mod, "_gather_channels", channels)

    def wrap(decoder, rec):
        def run(tar, cross, tr_m, te_m):
            accs = decoder(tar, cross, tr_m, te_m)
            rec.decodes.append((np.asarray(accs), np.asarray(te_m),
                                np.asarray(tar.y)))
            return accs
        return run

    monkeypatch.setattr(js, "_cv_decoder", lambda strategy, dcfg, n=0: wrap(
        jpool.make_cv_decoder(strategy, dcfg), jr))
    make = tpool.make_cv_decoder
    monkeypatch.setattr(ts, "make_cv_decoder",
                        lambda strategy, dcfg, mesh=None: wrap(
                            make(strategy, dcfg, mesh=mesh), tr))
    predict = tpool.kernel_classifier_predict

    def scored(clf, X, kernel):
        tr.scores.append(tcl.kernel_classifier_decision(clf, X, kernel))
        return predict(clf, X, kernel)

    monkeypatch.setattr(tpool, "kernel_classifier_predict", scored)
    return jr, tr


def _slack(y, te, scores):
    """Per fold, the balanced-accuracy weight of the undecided test
    trials."""
    top2 = scores.double().topk(2, dim=-1).values.numpy()
    und = top2[..., 0] - top2[..., 1] <= DECIDED * np.abs(top2).max(-1)
    out = []
    for f in range(len(te)):
        cls, support = np.unique(y[te[f] > 0], return_counts=True)
        w = dict(zip(cls, 1.0 / (len(cls) * support)))
        out.append(sum(w[y[i]] for i in np.where((te[f] > 0) & und[f])[0]))
    return np.asarray(out)


def _assert_same_draws(jr, tr):
    for name in ("masks", "trials", "channels"):
        got, want = getattr(tr, name), getattr(jr, name)
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            for a, b in zip(*(x if isinstance(x, tuple) else (x,)
                              for x in (g, w))):
                np.testing.assert_array_equal(a, b, err_msg=name)


def _assert_same_sweep(res_t, res_j, jr, tr):
    """Draws equal; every decode's fold accuracies, and every sweep
    point's mean, within the weight of its undecided test trials."""
    _assert_same_draws(jr, tr)
    assert len(tr.decodes) == len(jr.decodes) == len(tr.scores) > 0
    slack = []
    for (a_t, te_t, y_t), (a_j, te_j, y_j), sc in zip(tr.decodes, jr.decodes,
                                                      tr.scores):
        np.testing.assert_array_equal(te_t, te_j)
        np.testing.assert_array_equal(y_t, y_j)
        s = _slack(y_t, te_t, sc)
        assert (np.abs(a_t - a_j) <= ACC_ATOL + s).all(), (a_t, a_j, s)
        slack.append(s.mean())
    if isinstance(res_j, tuple):  # the trial sweep: (ks, (n_k, n_iter))
        np.testing.assert_array_equal(res_t[0], res_j[0])
        got, want = res_t[1].ravel(), res_j[1].ravel()
    else:
        assert list(res_t) == list(res_j)
        got = np.concatenate([res_t[k] for k in res_t])
        want = np.concatenate([res_j[k] for k in res_j])
    assert got.shape == want.shape == (len(slack),)
    assert (np.abs(got - want) <= ACC_ATOL + np.asarray(slack)).all()
    assert np.isfinite(got).all() and 0 <= got.min() and got.max() <= 1


def _same_results_file(path_t, path_j):
    got, want = tload.load_pkl(path_t), jload.load_pkl(path_j)
    assert set(got) == set(want) == {"params", "sweep", "results"}
    assert got["sweep"] == want["sweep"]
    assert got["params"] == {**want["params"], "out": got["params"]["out"]}
    assert list(got["results"]) == list(want["results"])


# ------------------------------------------------- data/subsample.py ----

def _positions(h, w):
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return np.stack([ys.ravel(), xs.ravel()], 1).astype(float)


_CMAP = np.arange(1, 49, dtype=float).reshape(6, 8)
_CMAP[0, 0] = _CMAP[-1, -1] = _CMAP[2, 5] = np.nan
_SIG = np.array([2, 3, 9, 10, 17, 20, 21, 30, 33, 41, 44, 47])

SUBSAMPLE_CASES = {
    "grid_square": lambda m, rng: m.grid_subsample_sig_channels(
        _CMAP, _SIG, 3),
    "grid_rect_step": lambda m, rng: m.grid_subsample_sig_channels(
        _CMAP, _SIG, (2, 4), step=(2, 1)),
    "spatial_avg_groups": lambda m, rng: m.spatial_avg_groups(_CMAP, 3),
    "spatial_avg_data": lambda m, rng: m.spatial_avg_data(
        rng.normal(size=(5, 4, 12)), m.spatial_avg_groups(_CMAP, 2),
        channel_ids=_SIG),
    "spatial_avg_matrix": lambda m, rng: m.spatial_avg_matrix(
        m.spatial_avg_groups(_CMAP, 2), channel_ids=_SIG),
    "spatial_avg_matrix_ids": lambda m, rng: m.spatial_avg_matrix(
        [np.array([0, 1]), np.array([5]), np.array([40])], n_channels=6),
    "array_distance": lambda m, rng: [
        m.array_distance(rng.normal(size=(6, 2)), rng.normal(size=(4, 2)),
                         kind) for kind in ("mean", "min", "max")],
    "poisson_disk_max": lambda m, rng: m.poisson_disk_sample(
        _positions(7, 9), 2.0, rng),
    "poisson_disk_budget": lambda m, rng: m.poisson_disk_sample(
        _positions(7, 9), 1.5, rng, k=10, n_points=12),
    "pitch_sig_ids": lambda m, rng: m.pitch_subsample_sig_channels(
        _positions(6, 8), _SIG, 2.5, rng,
        channel_ids=np.arange(1, 49)),
    "pitch_sig_positions": lambda m, rng: m.pitch_subsample_sig_channels(
        _positions(4, 5), np.array([3, 7, 11]), 1.5, rng),
    "array_geometry": lambda m, rng: [m.array_geometry(pt) for pt in
                                      sorted(m.ARRAY_GEOMETRY_MM)],
    "pitch_to_n": lambda m, rng: [m.pitch_to_n_electrodes(p, 37.8, 20.6)
                                  for p in (0.5, 1.5, 2.5, 4.0)],
    "pitch_mm_subset": lambda m, rng: [m.pitch_subsample_channels_mm(
        _CMAP, _SIG, p, 11.3, 22.5, 128, rng) for p in (2.5, 4.0, 6.0)],
    "pitch_mm_topup": lambda m, rng: m.pitch_subsample_channels_mm(
        _CMAP, _SIG, 1.5, 11.3, 22.5, 128, rng),
    "pitch_mm_all": lambda m, rng: m.pitch_subsample_channels_mm(
        _CMAP, _SIG, 1.0, 37.8, 20.6, 256, rng),
    "trial_indices": lambda m, rng: [m.trial_subsample_indices(
        np.repeat(np.arange(4), 6), k, rng) for k in (5, 13, 24, 40)],
    "trial_indices_thin": lambda m, rng: m.trial_subsample_indices(
        np.array([0] * 9 + [1] * 2 + [2] * 3), 12, rng),
    "knn": lambda m, rng: m.knn_indices(_positions(5, 5),
                                        rng.uniform(0, 4, (6, 2)), 3),
    "min_neighbor": lambda m, rng: m.min_neighbor_distance(
        _positions(3, 3), rng.uniform(0, 2, (4, 2))),
    "min_neighbor_empty": lambda m, rng: m.min_neighbor_distance(
        np.zeros((0, 2)), np.array([1.0, 2.0])),
}


def _flat(x):
    if isinstance(x, (list, tuple)):
        return [y for e in x for y in _flat(e)]
    return [np.asarray(x)]


@pytest.mark.parametrize("case", sorted(SUBSAMPLE_CASES))
def test_subsample_function_matches_jax_bitwise(case):
    """The same generator state gives the same indices (and values) in
    both packages, and leaves the generator in the same state."""
    fn = SUBSAMPLE_CASES[case]
    rng_t, rng_j = np.random.default_rng(7), np.random.default_rng(7)
    got, want = _flat(fn(tsub, rng_t)), _flat(fn(jsub, rng_j))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert rng_t.integers(2**62) == rng_j.integers(2**62)


def test_subsample_errors_match_jax():
    assert tsub.ARRAY_GEOMETRY_MM == jsub.ARRAY_GEOMETRY_MM
    for m in (tsub, jsub):
        with pytest.raises(KeyError, match="no physical array geometry"):
            m.array_geometry("S99")
        with pytest.raises(ValueError, match="mean\\|min\\|max"):
            m.array_distance(np.zeros((1, 2)), np.zeros((1, 2)), "median")
        with pytest.raises(ValueError, match="max_retries"):
            m.pitch_subsample_sig_channels(_positions(2, 2), [1], 1.0,
                                           np.random.default_rng(0), 0)


# ------------------------------------------------- .mat and geometry ----

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_geometry_files_read_by_the_other_package(tmp_path, writer):
    """Files written by one package's ``save_geometry_mat`` are read by
    the other's readers as by its own: the trimmed map, the transposed
    flag, the untrimmed map and the significant channels."""
    w, r = (jload, tload) if writer == "jax" else (tload, jload)
    geo = _maps(np.random.default_rng(1))
    for pt, (cmap, sig) in geo.items():
        w.save_geometry_mat(tmp_path, pt, cmap, sig)
    for pt, (cmap, sig) in geo.items():
        for trim in (True, False):
            got, got_t = r.load_channel_map(tmp_path, pt, trim=trim)
            want, want_t = w.load_channel_map(tmp_path, pt, trim=trim)
            np.testing.assert_array_equal(got, want)
            assert got_t == want_t
        np.testing.assert_array_equal(r.load_sig_channels(tmp_path, pt), sig)
    cmap22, transposed = r.load_channel_map(tmp_path, "S22")
    assert cmap22.shape == (22, 4) and transposed
    for pt in ("S14", "S22", "S23", "S26", "S33", "S39", "S58", "S62"):
        np.testing.assert_array_equal(tload.canonical_channel_map(pt),
                                      jload.canonical_channel_map(pt))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_high_gamma_mat_read_by_the_other_package(tmp_path, writer):
    """``save_high_gamma_mat`` of one package, ``load_high_gamma_mat`` and
    ``load_subject_phoneme_data`` of the other: the same arrays, keys and
    dtypes, with the ``hgTrace`` and ``cs_`` keys."""
    w, r = (jload, tload) if writer == "jax" else (tload, jload)
    rng = np.random.default_rng(2)
    for p in (1, 2, 3):
        X = rng.normal(size=(5, 7, 6)).astype(np.float32)
        y = rng.integers(1, 10, (5, 3))
        w.save_high_gamma_mat(tmp_path / w.mat_filename("S26", p), X, y,
                              cs={"2x2": X[..., :3], "cs_3x3": X[..., :2]})
    w.save_high_gamma_mat(tmp_path / "trace.mat", X, y,
                          hg_trace=rng.normal(size=(5, 2, 3, 7)))
    for name in [w.mat_filename("S26", p) for p in (1, 2, 3)] + ["trace.mat"]:
        got = r.load_high_gamma_mat(tmp_path / name)
        want = w.load_high_gamma_mat(tmp_path / name)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    got = r.load_subject_phoneme_data(tmp_path, "S26")
    want = w.load_subject_phoneme_data(tmp_path, "S26")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    for args in (("S14",), ("S14", 2, False, True), ("S62", None, True)):
        assert tload.mat_filename(*args) == jload.mat_filename(*args)


# ------------------------------------------------------------- sweeps ----

def test_subsample_config_matches_jax():
    """Field names, order and defaults: a results pickle's params read the
    same in both packages."""
    def spec(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert spec(ts.SubsampleConfig) == spec(js.SubsampleConfig)


def _cfgs(files, tmp_path, **kw):
    base = dict(data=files["pkl"], geometry_dir=files["dir"],
                target_pt="S14", n_iter=2, n_folds=3, max_k=8, seed=0)
    base.update(kw)
    return (js.SubsampleConfig(out=str(tmp_path / "j.pkl"), **base),
            ts.SubsampleConfig(out=str(tmp_path / "t.pkl"), **base))


SWEEPS = {
    "trials": ("run_trial_subsample", dict(k_start=5, k_step=25,
                                           n_iter=1)),
    "grid": ("run_grid_subsample", dict(win_sizes=(2, "2x3"), n_iter=1)),
    "spatial_file": ("run_spatial_avg", dict(contact_sizes=(2, 3),
                                             data="savg")),
    "pitch_mm": ("run_pitch_subsample", dict(pitches=(4.0,))),
}


@pytest.mark.parametrize("sweep", sorted(SWEEPS))
def test_sweep_matches_jax(files, tmp_path, recorded, sweep):
    """One sweep of each kind on the files: the same fold masks, trial
    and channel indices as JAX's driver, accuracies by the decided-trial
    rule, and a results pickle with JAX's keys."""
    fn, kw = SWEEPS[sweep]
    if kw.get("data") == "savg":
        kw = dict(kw, data=files["savg"])
    cfg_j, cfg_t = _cfgs(files, tmp_path, **kw)
    res_j = getattr(js, fn)(cfg_j, verbose=False)
    res_t = getattr(ts, fn)(cfg_t, verbose=False, device="cpu")
    _assert_same_sweep(res_t, res_j, *recorded)
    _same_results_file(cfg_t.out, cfg_j.out)


SYNTH_SWEEPS = {
    "grid": ("run_grid_subsample", dict(win_sizes=(6,))),
    "spatial": ("run_spatial_avg", dict(contact_sizes=(3,))),
    "pitch": ("run_pitch_subsample", dict(pitches=(2.0,))),
}


@pytest.mark.parametrize("sweep", sorted(SYNTH_SWEEPS))
def test_synthetic_fallback_sweep_matches_jax(tmp_path, host_synth, recorded,
                                              sweep):
    """Without geometry files: the fabricated square map, the on-device
    tile average ``X @ A`` and the unit-grid pitch, against JAX's."""
    fn, kw = SYNTH_SWEEPS[sweep]
    base = dict(n_iter=1, n_folds=3, max_k=8, trials_per_class=6, seed=1,
                **kw)
    res_j = getattr(js, fn)(js.SubsampleConfig(**base), verbose=False)
    res_t = getattr(ts, fn)(ts.SubsampleConfig(**base), verbose=False,
                            device="cpu")
    _assert_same_sweep(res_t, res_j, *recorded)


def test_nested_sweep_point_matches_jax(files, tmp_path, recorded,
                                       monkeypatch):
    """nested=true: one trial-sweep point, its TPE search seeded from the
    sweep's generator: the same trial indices, outer and inner masks and
    accuracy as JAX's."""
    from cross_patient_speech_decoding_tpu.data import splits as jsplits
    from cross_patient_speech_decoding_tpu_torch.decoders import (
        nested_cv as tnest,
    )

    jr, tr = recorded
    # JAX's search imports the split function where it calls it
    for mod, rec in ((jsplits, jr), (tnest, tr)):
        monkeypatch.setattr(mod, "stratified_kfold_masks",
                            lambda y, n, rng, _f=mod.stratified_kfold_masks,
                            _r=rec: _r.masks.append(_f(y, n, rng))
                            or _r.masks[-1])
    cfg_j, cfg_t = _cfgs(files, tmp_path, nested=True, n_iter=1, k_start=40,
                         k_step=100, nested_rounds=2, nested_points=2,
                         nested_inner=2)
    ks_j, acc_j = js.run_trial_subsample(cfg_j, verbose=False)
    ks_t, acc_t = ts.run_trial_subsample(cfg_t, verbose=False, device="cpu")
    assert len(tr.masks) == 1 + cfg_t.n_folds
    assert len(tr.trials) == len(PTS) - 1
    _assert_same_draws(jr, tr)
    np.testing.assert_array_equal(ks_t, ks_j)
    np.testing.assert_allclose(acc_t, acc_j, atol=ACC_ATOL)


@pytest.mark.parametrize("fn", ["run_trial_subsample", "run_grid_subsample",
                                "run_spatial_avg", "run_pitch_subsample"])
def test_n_devices_raises_before_any_work(tmp_path, fn):
    """n_devices=2 shards each sweep point's folds over two gloo ranks
    that the sweep launches (every rank draws the same indices and
    folds): the one-device results (atol 1e-6), the sweep pickle written
    once, by rank 0."""
    import torch_parallel_ranks as ranks

    kw = dict(n_iter=1, n_folds=2, max_k=10, trials_per_class=6,
              k_start=5, k_step=50, win_sizes=(2,), contact_sizes=(2,),
              pitches=(2.5,), seed=0)
    with ranks.threads(1):
        one = getattr(ts, fn)(ts.SubsampleConfig(**kw), verbose=False,
                              device="cpu")
    two = getattr(ts, fn)(ts.SubsampleConfig(
        n_devices=2, out=str(tmp_path / "x.pkl"), **kw), verbose=False,
        device="cpu")
    if isinstance(one, tuple):  # the trial sweep: (ks, accuracies)
        np.testing.assert_array_equal(two[0], one[0])
        one, two = {"accs": one[1]}, {"accs": two[1]}
    assert set(two) == set(one) and one
    for k in one:
        np.testing.assert_allclose(two[k], one[k], atol=1e-6)
    assert [p.name for p in tmp_path.iterdir()] == ["x.pkl"]


def test_sweep_errors_match_jax(files, tmp_path):
    """The JAX driver's refusals, with its messages: no cross patient in
    a trial sweep, geometry that does not match the data, a cross patient
    without a sub-grid, a savg pickle without the contact size."""
    cases = [
        ("run_trial_subsample", dict(pool_train=False), ValueError,
         "CROSS-patient"),
        ("run_grid_subsample", dict(win_sizes=(30,)), ValueError,
         "no sub-grid"),
        ("run_spatial_avg", dict(contact_sizes=(4,), data=files["savg"]),
         KeyError, "cs_4x4 not present"),
        ("run_spatial_avg", dict(contact_sizes=(2,)), TypeError, "cs_NxN"),
    ]
    for fn, kw, err, msg in cases:
        cfg_j, cfg_t = _cfgs(files, tmp_path, **kw)
        if fn == "run_grid_subsample":
            # a target window that fits, none of a cross patient's does
            cfg_j.win_sizes = cfg_t.win_sizes = ("4x6",)
        for mod, cfg, kwargs in ((js, cfg_j, {}), (ts, cfg_t,
                                                   {"device": "cpu"})):
            with pytest.raises(err, match=msg):
                getattr(mod, fn)(cfg, verbose=False, **kwargs)
    bad = tmp_path / "bad"
    for pt in PTS:
        tload.save_geometry_mat(bad, pt, np.arange(1, 25.0).reshape(4, 6),
                                np.arange(1, CHANS[pt] + 1))
    tload.save_geometry_mat(bad, "S14", np.arange(1, 25.0).reshape(4, 6),
                            np.arange(1, 6))
    cfg_j, cfg_t = _cfgs(files, tmp_path, geometry_dir=str(bad))
    for mod, cfg, kwargs in ((js, cfg_j, {}), (ts, cfg_t, {"device": "cpu"})):
        with pytest.raises(ValueError, match="does not match data"):
            mod.run_grid_subsample(cfg, verbose=False, **kwargs)


@pytest.mark.parametrize("cmd,extra", [
    ("subsample-trials", ["k_step=40"]),
    ("subsample-grid", ["win_sizes=2,3"]),
    ("subsample-spatial", ["contact_sizes=2"]),
    ("subsample-pitch", ["pitches=1.5"]),
])
def test_cli_subsample_runs_in_process(tmp_path, host_synth, capsys, cmd,
                                       extra):
    """``cli.main subsample-* device=cpu`` runs the port's sweep with
    key=value overrides (tuples as comma lists) and writes its pickle."""
    out = tmp_path / "sweep.pkl"
    args = [cmd, "device=cpu", "n_iter=1", "n_folds=2", "max_k=8",
            "trials_per_class=4", f"out={out}"] + extra
    assert tmain.main(args) == 0
    assert "acc" in capsys.readouterr().out
    store = tload.load_pkl(out)
    assert store["sweep"] == {"subsample-trials": "trials",
                              "subsample-grid": "grid",
                              "subsample-spatial": "spatial_avg",
                              "subsample-pitch": "pitch"}[cmd]
    assert "device" not in store["params"]
    # every command of the JAX CLI is ported: no refusal table is left
    assert cmd in tmain._COMMANDS and not hasattr(tmain, "_NOT_PORTED")
