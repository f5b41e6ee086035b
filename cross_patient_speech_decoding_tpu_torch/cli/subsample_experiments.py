"""Subsampling sweep experiments — data-quantity and electrode-geometry
scans of cross-patient decoding (``cpsd subsample-{trials,grid,spatial,
pitch}``).

Port of ``cross_patient_speech_decoding_tpu/cli/subsample_experiments.py``,
the analogs of the reference sweep scripts (SURVEY.md §2.7):
- :func:`run_trial_subsample`  <-> aligned_decode_cross_patient_subsample.py:
  accuracy vs number of cross-patient trials (k = 5, 30, 55, ... up to the
  cross-patient median, :290-292);
- :func:`run_grid_subsample`   <-> aligned_decode_grid_subsample.py:
  electrode-density sweep iterating ALL of the target's sliding sub-grids
  with a random cross-patient sub-grid each (:281-301);
- :func:`run_spatial_avg`      <-> aligned_decode_spatialAvg_subsample.py:
  contact-size sweep over the pre-averaged ``cs_{n}x{n}`` channels of a
  ``pt_savg_data*.pkl`` (:200-210);
- :func:`run_pitch_subsample`  <-> aligned_decode_pitch_subsample.py:
  electrode-pitch sweep via per-iteration Poisson-disk resampling at
  mm-scale pitch on the physical array dimensions
  (poisson_disk_sampling.py:38-45).

Geometry: when ``geometry_dir`` is set the sweeps load each patient's real
2-D channel map (``{pt}_channelMap.mat``) and significant-channel list
(``{pt}_sigChannel.mat``) exactly as the reference does
(aligned_decode_grid_subsample.py:26-30); otherwise they fall back to a
fabricated square map with every channel significant (synthetic data only).

Index generation is host-side numpy (``data/subsample.py``): each sweep
draws its indices, fold masks and nested-search seeds from one
``np.random.default_rng(seed)`` in the JAX package's order, so both
packages decode the same sub-grids, samples and folds. The decodes run on
``device`` (the first CUDA card by default) through the batched fold
program of ``decoders/pooled.py``: a sweep point's folds are one batch, so
each source patient's chol CCA fit is one ``jacobi_eigh`` launch on the
card where the source keeps at least ``ops.jacobi.ANY_BATCH_K`` latents
(``torch.linalg.eigh`` below). The JAX package caches one jitted decoder
per configuration to avoid retracing; the port runs eagerly, so it builds
the decoder at each sweep point (``make_cv_decoder`` holds no state).

``n_devices > 0`` shards each sweep point's folds over that many ranks
(``make_cv_decoder(mesh=)``, the nested search's outer folds likewise):
every rank draws the same indices and folds, decodes its block of folds
and gathers the rest. Called with no process group initialised, a sweep
launches its ranks itself and returns rank 0's result; only rank 0 writes
``out``.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from cross_patient_speech_decoding_tpu_torch.cli.experiments import (
    _build_patient_arrays,
    apply_pool_filters,
    patients_from_config,
)
from cross_patient_speech_decoding_tpu_torch.data.loaders import (
    decoding_data_from_dict,
    load_channel_map,
    load_pkl,
    load_sig_channels,
    save_pkl,
)
from cross_patient_speech_decoding_tpu_torch.data.splits import (
    stratified_kfold_masks,
)
from cross_patient_speech_decoding_tpu_torch.data.subsample import (
    array_geometry,
    grid_subsample_sig_channels,
    pitch_subsample_channels_mm,
    pitch_subsample_sig_channels,
    spatial_avg_groups,
    spatial_avg_matrix,
    trial_subsample_indices,
)
from cross_patient_speech_decoding_tpu_torch.decoders.nested_cv import (
    nested_cv_decode_bayes,
)
from cross_patient_speech_decoding_tpu_torch.decoders.pooled import (
    DecodeConfig,
    PatientArrays,
    make_cv_decoder,
)
from cross_patient_speech_decoding_tpu_torch.ops.precision import hdot
from cross_patient_speech_decoding_tpu_torch.parallel.mesh import (
    is_writer,
    launch_driver,
    make_mesh,
    mesh_and_device,
    needs_launch,
)


@dataclass
class SubsampleConfig:
    """Electrode/trial subsampling sweeps (grid / spatial-average /
    pitch / trial-count; the aligned_decode_*_subsample.py script
    family)."""

    data: str = "synthetic"
    target_pt: str = "S14"
    strategy: str = "sep_align"
    n_iter: int = 10  # <=0: all target sub-grids (grid sweep, the
    # reference default aligned_decode_grid_subsample.py:281)
    n_folds: int = 5
    n_comp: float = 0.8
    max_k: int = 24
    lam: float = 1.0
    # -po/-t/-pp flags shared with the decode scripts (single-patient
    # branch / target rows in the pool / named cross subset —
    # aligned_decode_grid_subsample.py:112-120,195-197)
    pool_train: bool = True
    tar_in_train: bool = True
    pooled_pts: str = "all"
    # -r control (aligned_decode_cross_patient_subsample.py): replace the
    # cross-patient tensors with uniform noise
    random_data: bool = False
    # -cv flag: per-sweep-point nested TPE hyperparameter search
    # (aligned_decode_grid_subsample.py:127-151,335)
    nested: bool = False
    nested_rounds: int = 2
    nested_points: int = 3
    nested_inner: int = 3
    # fold sharding over n ranks, one device each; 0 = one device
    n_devices: int = 0
    seed: int = 0
    # real electrode geometry: dir holding {pt}/{pt}_channelMap.mat +
    # {pt}_sigChannel.mat ('' = fabricate a square map, synthetic only)
    geometry_dir: str = ""
    # trial sweep
    k_start: int = 5
    k_step: int = 25
    # grid sweep: ints (square) or 'AxB' strings (the reference's "x-y")
    win_sizes: tuple = (2, 4, 6)
    # spatial averaging
    contact_sizes: tuple = (2, 4)
    # pitch sweep — mm when geometry_dir is set (reference pitches are
    # mm-scale), electrode-grid units for the synthetic fallback
    pitches: tuple = (1.5, 2.5, 4.0)
    # synthetic-data difficulty (ignored for file-backed data): sweeps are
    # only informative when the base problem is not saturated
    noise: float = 0.6
    trials_per_class: int = 15
    out: str = ""  # optional results pickle


def _sweep_device(cfg: SubsampleConfig, device):
    """(this rank's device, whether it writes ``out``) of a sweep run
    inside its ranks (or on one device for ``n_devices == 0``)."""
    mesh, dev = mesh_and_device(cfg.n_devices, device)
    return dev, is_writer(mesh)


def _mesh(cfg: SubsampleConfig, dev):
    """The fold mesh of a decode on ``dev``: None for one device."""
    return make_mesh(cfg.n_devices, device=dev) if cfg.n_devices > 0 \
        else None


def _decode_config(cfg: SubsampleConfig, n_y: int, n_a: int) -> DecodeConfig:
    return DecodeConfig(
        n_comp=cfg.n_comp, max_k=cfg.max_k, n_classes=n_y,
        n_align_classes=n_a, lam=cfg.lam,
        tar_in_train=cfg.tar_in_train or not cfg.pool_train,
    )


def _setup(cfg: SubsampleConfig, dev):
    tar, cross, n_y, n_a, names = patients_from_config(
        cfg.data, cfg.target_pt, seed=cfg.seed, noise=cfg.noise,
        random_data=cfg.random_data,
        trials_per_class=cfg.trials_per_class, return_names=True,
        device=dev,
    )
    cross, cross_names = apply_pool_filters(
        cross, names[1:], cfg.pool_train, cfg.pooled_pts
    )
    return tar, cross, _decode_config(cfg, n_y, n_a), [names[0],
                                                       *cross_names]


def _decode(tar, cross, dcfg, cfg: SubsampleConfig, rng, tar_y_host=None):
    """Mean CV accuracy of one sweep point; ``nested=True`` runs the
    reference's per-fold BayesSearchCV analog at every point instead of
    the fixed-hyperparameter fit (aligned_decode_grid_subsample.py:335).
    The one host read is the accuracies'."""
    if cfg.nested:
        accs, _ = nested_cv_decode_bayes(
            tar, tuple(cross), dcfg, n_folds=cfg.n_folds,
            n_rounds=cfg.nested_rounds, n_points=cfg.nested_points,
            n_inner=cfg.nested_inner, strategy=cfg.strategy,
            seed=int(rng.integers(2**31)),
            mesh=_mesh(cfg, tar.X.device),
        )
        return float(np.asarray(accs).mean())
    decoder = make_cv_decoder(cfg.strategy, dcfg,
                              mesh=_mesh(cfg, tar.X.device))
    if tar_y_host is None:
        tar_y_host = tar.y.cpu().numpy()
    tr, te = stratified_kfold_masks(tar_y_host, cfg.n_folds, rng)
    dev = tar.X.device
    accs = decoder(tar, tuple(cross),
                   torch.as_tensor(tr, dtype=torch.float32, device=dev),
                   torch.as_tensor(te, dtype=torch.float32, device=dev))
    return float(accs.cpu().numpy().mean())


def _save_results(cfg: SubsampleConfig, sweep: str, results,
                  writes: bool = True):
    if cfg.out and writes:
        path = Path(cfg.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        save_pkl({"params": vars(cfg), "sweep": sweep, "results": results},
                 path)


def _take_trials(pt: PatientArrays, idx: np.ndarray) -> PatientArrays:
    i = torch.as_tensor(idx, device=pt.X.device)
    return PatientArrays(X=pt.X[i], y=pt.y[i], y_align=pt.y_align[i])


def run_trial_subsample(cfg: SubsampleConfig, verbose: bool = True,
                        device=None):
    """Accuracy vs cross-patient trial count -> (ks, (n_k, n_iter)
    accuracies)."""
    if needs_launch(cfg.n_devices):
        return launch_driver(run_trial_subsample, cfg.n_devices, device, cfg, verbose)
    dev, writes = _sweep_device(cfg, device)
    verbose = verbose and writes
    tar, cross, dcfg, _ = _setup(cfg, dev)
    if not cross:
        raise ValueError(
            "the trial-count sweep subsamples CROSS-patient trials; it "
            "needs pool_train=True and a non-empty pooled_pts selection"
        )
    rng = np.random.default_rng(cfg.seed)
    median_n = int(np.median([c.X.shape[0] for c in cross]))
    ks = list(range(cfg.k_start, median_n + 1, cfg.k_step))

    # host label copies once per patient
    tar_y_host = tar.y.cpu().numpy()
    cross_y_host = [c.y.cpu().numpy() for c in cross]

    results = np.zeros((len(ks), cfg.n_iter))
    for ki, k in enumerate(ks):
        for it in range(cfg.n_iter):
            sub_cross = [
                _take_trials(c, trial_subsample_indices(y_host, k, rng))
                for c, y_host in zip(cross, cross_y_host)
            ]
            results[ki, it] = _decode(tar, sub_cross, dcfg, cfg, rng,
                                      tar_y_host=tar_y_host)
        if verbose:
            print(f"k={k}: acc {results[ki].mean():.3f}", flush=True)
    _save_results(cfg, "trials", {"ks": np.asarray(ks), "accs": results},
                  writes)
    return np.asarray(ks), results


# ------------------------------------------------------ geometry loading ----

def _square_map(n_channels: int):
    """Fallback 2-D layout: square map, channel numbers 1..n, all
    significant (synthetic geometry only)."""
    w = int(np.ceil(np.sqrt(n_channels)))
    h = int(np.ceil(n_channels / w))
    m = np.full((h, w), np.nan)
    m.ravel()[:n_channels] = np.arange(1, n_channels + 1)
    return m


def _patient_geometry(cfg: SubsampleConfig, names, pts):
    """Per-patient (chan_map, sig_channels, transposed) triples.

    Real geometry from ``geometry_dir`` (reference .mat contract); the
    fabricated fallback marks every data channel significant. Validates
    that each significant-channel list matches the data channel count —
    the data channel axis IS the sig-channel list, in order.
    """
    out = []
    for name, p in zip(names, pts):
        n_ch = int(p.X.shape[-1])
        if cfg.geometry_dir:
            cmap, transposed = load_channel_map(cfg.geometry_dir, name)
            sig = load_sig_channels(cfg.geometry_dir, name)
            if len(sig) != n_ch:
                raise ValueError(
                    f"{name}: sigChannel has {len(sig)} channels but the "
                    f"data has {n_ch} — geometry does not match data"
                )
        else:
            cmap, transposed = _square_map(n_ch), False
            sig = np.arange(1, n_ch + 1)
        out.append((cmap, sig, transposed))
    return out


def _gather_channels(pt: PatientArrays, ch_idx: np.ndarray) -> PatientArrays:
    idx = torch.as_tensor(ch_idx, device=pt.X.device)
    return PatientArrays(X=pt.X[:, :, idx], y=pt.y, y_align=pt.y_align)


def _parse_win(win):
    """Window spec -> (rows, cols): int, (h, w) tuple, or 'AxB'/'A-B' str
    (the reference passes win_size as a "x-y" string)."""
    if isinstance(win, str):
        for sep in ("x", "-"):
            if sep in win:
                a, b = win.split(sep)
                return (int(a), int(b))
        return (int(win), int(win))
    if np.isscalar(win):
        return (int(win), int(win))
    return (int(win[0]), int(win[1]))


def run_grid_subsample(cfg: SubsampleConfig, verbose: bool = True,
                       device=None):
    """Accuracy vs sub-grid size -> {win: accuracies}.

    The target iterates ALL of its sub-grid positions (the reference's
    iteration loop, aligned_decode_grid_subsample.py:281-301; capped at
    ``n_iter`` when positive) while each cross patient contributes one
    random sub-grid per iteration. With ``geometry_dir`` the sub-grids
    slide over each patient's real NaN-edged channel map; 24-wide maps are
    edge-trimmed and the window transposed as the reference does
    (grid_subsampling.py:33-38).
    """
    if needs_launch(cfg.n_devices):
        return launch_driver(run_grid_subsample, cfg.n_devices, device, cfg, verbose)
    dev, writes = _sweep_device(cfg, device)
    verbose = verbose and writes
    tar, cross, dcfg, names = _setup(cfg, dev)
    rng = np.random.default_rng(cfg.seed)
    geom = _patient_geometry(cfg, names, (tar, *cross))
    tar_y_host = tar.y.cpu().numpy()
    results = {}
    for win in cfg.win_sizes:
        wh, ww = _parse_win(win)
        grids = []
        for cmap, sig, transposed in geom:
            w = (ww, wh) if transposed else (wh, ww)
            grids.append(grid_subsample_sig_channels(cmap, sig, w))
        if not grids[0]:
            if verbose:
                print(f"win={win}: no target sub-grid contains a "
                      "significant channel; skipped", flush=True)
            continue
        if any(not g for g in grids[1:]):
            raise ValueError(
                f"win={win}: a cross patient has no sub-grid with "
                "significant channels"
            )
        n_run = len(grids[0]) if cfg.n_iter <= 0 else min(
            cfg.n_iter, len(grids[0])
        )
        accs = []
        for it in range(n_run):
            sub_tar = _gather_channels(tar, grids[0][it])
            sub_cross = [
                _gather_channels(c, g[rng.integers(len(g))])
                for c, g in zip(cross, grids[1:])
            ]
            accs.append(
                _decode(sub_tar, sub_cross, dcfg, cfg, rng,
                        tar_y_host=tar_y_host)
            )
        results[win] = np.asarray(accs)
        if verbose:
            print(
                f"win={win}: acc {results[win].mean():.3f} over "
                f"{n_run}/{len(grids[0])} target sub-grids",
                flush=True,
            )
    _save_results(cfg, "grid", results, writes)
    return results


def _savg_patients(cfg: SubsampleConfig, contact_size: int, data: dict,
                   dev):
    """Patient arrays from a loaded ``pt_savg_data*.pkl`` dict at one
    contact size (the pkl is read ONCE by the sweep, not per size).

    The reference's spatialAvg driver reads the same nested decoding dict
    but with each X entry a dict of pre-averaged channel sets keyed
    ``cs_{n}x{n}`` (aligned_decode_spatialAvg_subsample.py:189-210).
    """
    cs_key = f"cs_{contact_size}x{contact_size}"
    (X_t, y_t, ya_t), pre = decoding_data_from_dict(data, cfg.target_pt, -1)
    pre, _ = apply_pool_filters(
        pre, list(data[cfg.target_pt]["pre_pts"]), cfg.pool_train,
        cfg.pooled_pts,
    )

    def pick(X):
        if not isinstance(X, dict):
            raise TypeError(
                "spatial-avg file sweep needs a pt_savg_data pkl whose X "
                f"entries are dicts keyed cs_NxN; got {type(X).__name__}"
            )
        if cs_key not in X:
            raise KeyError(
                f"{cs_key} not present; available: {sorted(X)}"
            )
        return np.asarray(X[cs_key], np.float32)

    Xs = [pick(X_t)] + [pick(X) for X, _, _ in pre]
    ys = [y_t] + [y for _, y, _ in pre]
    aligns = [ya_t] + [ya for _, _, ya in pre]
    pts, n_y, n_a = _build_patient_arrays(Xs, ys, aligns, dev)
    return pts[0], pts[1:], _decode_config(cfg, n_y, n_a)


def run_spatial_avg(cfg: SubsampleConfig, verbose: bool = True,
                    device=None):
    """Accuracy vs simulated contact size -> {contact size: accuracies}.

    File-backed runs consume the pre-averaged ``cs_{n}x{n}`` channel sets
    of a ``pt_savg_data*.pkl`` (the reference's data path); the synthetic
    fallback averages channel tiles of the fabricated square map on the
    device (``X @ A`` in true float32, ``A`` the host-built tile-average
    matrix of ``spatial_avg_subsampling.py``'s tiling).
    """
    if needs_launch(cfg.n_devices):
        return launch_driver(run_spatial_avg, cfg.n_devices, device, cfg, verbose)
    dev, writes = _sweep_device(cfg, device)
    verbose = verbose and writes
    results = {}
    if cfg.data != "synthetic":
        rng = np.random.default_rng(cfg.seed)
        data = load_pkl(cfg.data)
        for cs in cfg.contact_sizes:
            tar, crs, dcfg = _savg_patients(cfg, int(cs), data, dev)
            tar_y_host = tar.y.cpu().numpy()
            accs = [
                _decode(tar, crs, dcfg, cfg, rng, tar_y_host=tar_y_host)
                for _ in range(cfg.n_iter)
            ]
            results[cs] = np.asarray(accs)
            if verbose:
                print(f"contact={cs}x{cs}: acc {results[cs].mean():.3f}",
                      flush=True)
        _save_results(cfg, "spatial_avg", results, writes)
        return results

    tar, cross, dcfg, names = _setup(cfg, dev)
    rng = np.random.default_rng(cfg.seed)
    geom = _patient_geometry(cfg, names, (tar, *cross))
    tar_y_host = tar.y.cpu().numpy()
    for cs in cfg.contact_sizes:
        pts_avg = []
        for p, (cmap, sig, _) in zip((tar, *cross), geom):
            groups = spatial_avg_groups(cmap, int(cs))
            A = spatial_avg_matrix(groups, channel_ids=sig,
                                   n_channels=p.X.shape[-1])
            Xa = hdot(p.X, torch.as_tensor(A, device=dev))
            pts_avg.append(PatientArrays(X=Xa, y=p.y, y_align=p.y_align))
        accs = [
            _decode(pts_avg[0], pts_avg[1:], dcfg, cfg, rng,
                    tar_y_host=tar_y_host)
            for _ in range(cfg.n_iter)
        ]
        results[cs] = np.asarray(accs)
        if verbose:
            print(f"contact={cs}x{cs}: acc {results[cs].mean():.3f}",
                  flush=True)
    _save_results(cfg, "spatial_avg", results, writes)
    return results


def run_pitch_subsample(cfg: SubsampleConfig, verbose: bool = True,
                        device=None):
    """Accuracy vs electrode pitch (Poisson-disk resampled every iter)
    -> {pitch: accuracies}.

    With real geometry the pitch is physical millimeters: the electrode
    budget comes from each patient's array area (128-contact 11.3x22.5 mm
    / 256-contact 37.8x20.6 mm, poisson_disk_sampling.py:38-45) and
    sampling runs on the patient's channel map. The synthetic fallback
    treats pitch in unit-grid spacing on the fabricated map.
    """
    if needs_launch(cfg.n_devices):
        return launch_driver(run_pitch_subsample, cfg.n_devices, device, cfg, verbose)
    dev, writes = _sweep_device(cfg, device)
    verbose = verbose and writes
    tar, cross, dcfg, names = _setup(cfg, dev)
    rng = np.random.default_rng(cfg.seed)
    geom = _patient_geometry(cfg, names, (tar, *cross))
    tar_y_host = tar.y.cpu().numpy()
    results = {}
    for pitch in cfg.pitches:
        accs = []
        for _ in range(cfg.n_iter):
            pts_sub = []
            for name, p, (cmap, sig, _) in zip(names, (tar, *cross), geom):
                if cfg.geometry_dir:
                    mm_x, mm_y, max_elec = array_geometry(name)
                    idx = pitch_subsample_channels_mm(
                        cmap, sig, float(pitch), mm_x, mm_y, max_elec, rng
                    )
                else:
                    # fallback positions are in channel order, so position
                    # indices ARE data channel indices
                    ys_, xs_ = np.nonzero(~np.isnan(cmap))
                    pos = np.stack([xs_, ys_], 1).astype(float)
                    _, idx = pitch_subsample_sig_channels(
                        pos, np.arange(len(sig)), float(pitch), rng
                    )
                if not len(idx):
                    raise ValueError(
                        f"{name}: pitch {pitch} sampled no significant "
                        "channels after retries"
                    )
                pts_sub.append(_gather_channels(p, idx))
            accs.append(
                _decode(pts_sub[0], pts_sub[1:], dcfg, cfg, rng,
                        tar_y_host=tar_y_host)
            )
        results[pitch] = np.asarray(accs)
        if verbose:
            print(f"pitch={pitch}: acc {results[pitch].mean():.3f}",
                  flush=True)
    _save_results(cfg, "pitch", results, writes)
    return results
