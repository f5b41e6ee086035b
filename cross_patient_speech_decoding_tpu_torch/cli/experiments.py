"""The experiment drivers: ``run_train_ctc`` (``cpsd train-ctc``),
``run_svm_decode`` (``cpsd svm-decode``), ``run_train_seq2seq`` (``cpsd
train-seq2seq``), ``run_train_nn`` (``cpsd train-nn``), the two prewarm
commands, ``run_tune_ctc`` (``cpsd tune-ctc``), ``run_make_xforms``
(``cpsd make-xforms``), ``run_realtime_sim`` (``cpsd realtime-sim``) and
``run_analyze`` (``cpsd analyze``).

Port of ``cross_patient_speech_decoding_tpu/cli/experiments.py``: its
CTC, seq2seq, NN-classifier, classical-decode, prewarm, tune, make-xforms,
realtime-sim and analyze sections.

``run_svm_decode`` is the analog of the reference's
``aligned_decode_svm[_ncv].py``: repeated stratified CV of pooled
cross-patient classical decoding (``decoders/pooled.py``, optionally the
nested TPE search of ``decoders/nested_cv.py``), with the same numpy
splits as the JAX package, per-iteration results appended to a pickle and
a resume from it, and the reference's controls (chance labels, noise for
the cross patients' data, and their TME and mode-shuffle surrogates of
``data/surrogates.py``). Its synthetic data is drawn on the card
(``make_synthetic_patients_device``).

``run_train_seq2seq`` is the analog of ``train_seq2seq.py``: per-fold
PCA of the target and chol CCA of each source into it, refitted on the
fold's train rows with the folds a batch axis (one Jacobi launch per
source on the card), then a Seq2SeqRNN per fold, through the fold trainer
of ``train/fold_parallel.py`` (one model per fold in turn, where the JAX
package vmaps the folds) or one ``train.loops.fit`` per fold. Splits are
the JAX package's numpy draws; weights come from ``Seq2SeqRNN(seed=)``,
the dropout masks, coins and augmentations from ``torch.Generator``s.

``run_train_nn`` is the working analog of the reference's
``aligned_decode_nn.py`` (which never builds its classifier): per fold,
the target's PCA and each source's chol CCA refitted on the fold's train
rows (one Jacobi launch a source on the card), the sources' own latents
fitted once a run; a TCN, transformer, CNN-transformer or conv-GRU
classifier per fold through ``train.loops.fit``, tested after the last
epoch. Fold k of iteration it draws its weights from ``seed + 31 it + k``
(on the host, so every device starts from the same weights) and its
dropout from ``seed + 1000 + 31 it + k`` (a generator on the run's
device), the numbers of the JAX package's keys.

``run_train_ctc`` is the analog of ``train_ctc_rnn.py``. One run trains
and tests the realtime CTC RNN in one of four contexts: ``chance`` (target data, labels permuted or drawn
at random), ``patient`` (target data only), ``unaligned`` (the target
pooled with cross patients, each PCA'd to 32 latents) and ``aligned``
(the cross patients' latents mapped into the target's by class-averaged
CCA). Each of ``n_iter`` iterations splits the target, prepares the
pooled set, augments it, trains with ``train.loops.fit``, tests, and
appends its PER to a results pickle, from which a rerun resumes.

The same numpy ``rng`` calls happen in the same order as in the JAX
package, so splits, chance labels and subsamples are equal. Where the
JAX package draws from ``jax.random.key(seed + k)``, the port draws from
a ``torch.Generator`` on the run's device seeded with the same integer:
the initial weights from ``seed + it`` (``RealtimeRNN``'s own generator),
the augmentations from ``seed + 500 + it``, dropout from
``seed + 1000 + it``. Those streams differ from JAX's by design.

The prewarm commands build the kernel libraries and run one epoch, which
pays the card's library set-up; the JAX package filled its compile cache
there, which the port does not have.

``run_tune_ctc`` (``cpsd tune-ctc``) is the analog of tune_ctc_rnn.py:
random or TPE/BOHB search through successive-halving rungs over the CTC
bucket trainers of ``sweep/ctc.py``, on a held-out split or with k-fold
CV, resumable from its manifest, handing the winner to ``train-ctc
hparam_dir=``. ``run_make_xforms`` (``cpsd make-xforms``) writes the
offline PCA/CCA transforms that ``pca_path=``/``cca_path=`` read: PCA in
float64 on the host, the ``gram`` CCA fits on the run's device.
``run_realtime_sim`` (``cpsd realtime-sim``) streams a random or a
checkpoint-imported model (``models/torch_import.py``) and reports its
latency; ``run_train_ctc``'s ``init_ckpt`` fine-tunes such a checkpoint.

``run_analyze`` (``cpsd analyze``) computes the paper's statistics over
saved results files on the host.

``n_devices > 0`` runs a driver on that many ranks (``parallel/``): the
CTC and classifier steps data-parallel, the decoders' and the seq2seq
trainer's folds and the tune buckets' models sharded. Each rank runs the
driver's seeded preparation the same way; only the sharded work and its
reductions cross ranks, and only rank 0 writes files. Called with no
process group initialised, a driver launches its ranks itself and returns
rank 0's result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import re
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from cross_patient_speech_decoding_tpu_torch.data import (
    make_synthetic_patients_device,
)
from cross_patient_speech_decoding_tpu_torch.data.loaders import (
    append_results_pkl,
    load_pkl,
)
from cross_patient_speech_decoding_tpu_torch.data.splits import (
    train_val_test_masks,
)
from cross_patient_speech_decoding_tpu_torch.parallel.mesh import (
    from_rank0,
    is_writer,
    launch_driver,
    mesh_and_device,
    needs_launch,
)
from cross_patient_speech_decoding_tpu_torch.utils.config import (
    MakeXformsConfig,
    RealtimeSimConfig,
    SVMDecodeConfig,
    TrainCTCConfig,
    TrainNNConfig,
    TrainSeq2SeqConfig,
    TuneCTCConfig,
)
from cross_patient_speech_decoding_tpu_torch.utils.device import (
    resolve_device,
)
from cross_patient_speech_decoding_tpu_torch.utils.labels import (
    encode_label_sequences,
    to_class_ids,
)

# Pooled contexts fit PCA and CCA to this common latent width.
MAX_K = 32

# ---------------------------------------------------------- synthetic data --

# One entry, keyed by (seed, sizes, device): pooled synthetic contexts
# re-prepare every iteration, but the dataset is a function of its key, so
# it is made once. One entry only: at reference scale it holds ~0.4 GB of
# device memory, and a sweep over seeds in one process must drop the last
# seed's arrays. Values are (X tensor on the device, labels, input lengths,
# label lengths as numpy) per patient; no caller changes them in place.
_SYNTH_CTC_CACHE: dict = {}


def _synthetic_ctc_key(seed, n_patients, n_trials, T, channels, vocab,
                       seq_len, device) -> tuple:
    return (seed, n_patients, n_trials, T, tuple(channels), vocab, seq_len,
            str(resolve_device(device)))


def _synthetic_ctc(seed=0, n_patients=3, n_trials=120, T=200,
                   channels=(64, 80, 72), vocab=9, seq_len=3, device=None):
    """Synthetic CTC dataset: per patient (X (N, T, C) float32 on the
    device, labels (N, seq_len) in 1..9, input lengths, label lengths)."""
    key = _synthetic_ctc_key(seed, n_patients, n_trials, T, channels, vocab,
                             seq_len, device)
    if key in _SYNTH_CTC_CACHE:
        return _SYNTH_CTC_CACHE[key]
    _SYNTH_CTC_CACHE.clear()  # free the last entry before making this one
    ds = make_synthetic_patients_device(
        seed=seed, n_patients=n_patients, n_classes=min(27, vocab**2),
        trials_per_class=max(1, n_trials // 27), T=T, channels=channels,
        latent_dim=12, noise=0.5, seq_len=seq_len, device=device)
    out = []
    for p in range(n_patients):
        n = len(ds.X[p])
        out.append((
            ds.X[p].to(torch.float32).contiguous(),
            np.asarray(ds.y_seq[p], np.int32),
            np.full(n, T, np.int32),
            np.full(n, seq_len, np.int32),
        ))
    _SYNTH_CTC_CACHE[key] = out
    return out


def _synthetic_ctc_channels(cfg) -> tuple:
    n_p = getattr(cfg, "synth_patients", 3)
    return (64, 80, 72, 111, 96, 128, 56, 104)[:n_p]


def _synthetic_ctc_cfg(cfg, device=None):
    """:func:`_synthetic_ctc` sized by the config's ``synth_*`` knobs
    (reference CTC production scale: 8 patients, ~250 trials, T=600)."""
    return _synthetic_ctc(
        seed=cfg.seed, n_patients=getattr(cfg, "synth_patients", 3),
        n_trials=getattr(cfg, "synth_trials", 120),
        T=getattr(cfg, "synth_T", 200), channels=_synthetic_ctc_channels(cfg),
        device=device,
    )


def _synthetic_ctc_n_trials(cfg) -> int:
    """Per-patient trial count of :func:`_synthetic_ctc_cfg` without making
    the dataset (27 sequence classes x trials // 27 each)."""
    return 27 * max(1, getattr(cfg, "synth_trials", 120) // 27)


# ------------------------------------------------------------------- prep --

def _pca_fit_lat(X, mask, n_comp, max_k):
    """Per-patient PCA (the CTC datamodules' low-component guard,
    ``low_refit_k=30``) and the patient's latents, each component's sign
    fixed as the fold program fixes it (``decoders.pooled._pca_latents``),
    so a run sees the same latents on every device."""
    from cross_patient_speech_decoding_tpu_torch.decoders.pooled import (
        _pca_latents,
    )

    return _pca_latents(X, n_comp, max_k, mask, low_refit_k=30)


def _pca_apply(st, X, max_k):
    from cross_patient_speech_decoding_tpu_torch.decoders.pooled import (
        _transform_latents,
    )

    return _transform_latents(st, X, max_k)


def _cca_align_lat(lat_a, lat_b, ids_a, ids_b, mask_a, n_classes):
    """A cross patient's latents mapped into the target's by class-averaged
    CCA (``chol``), fitted on the target rows of ``mask_a``."""
    from cross_patient_speech_decoding_tpu_torch.ops.cca import (
        fit_cca_aligner,
        transform_b_to_a,
    )

    al = fit_cca_aligner(lat_a, lat_b, ids_a, ids_b, n_classes,
                         mask_a=mask_a)
    return transform_b_to_a(al, lat_b)


def _tuple_arg(s: str):
    return tuple(float(x) for x in str(s).split(","))


def _subsample_ctc_set(d, frac: float, rng: np.random.Generator):
    """Stratified (by first label) row subsample of one CTC dataset tuple,
    the fig_5 data-scaling axis applied to a cross patient's trials."""
    X, y, il, ll = d
    y = np.asarray(y)
    keep = []
    for c in np.unique(y[:, 0]):
        idx = np.where(y[:, 0] == c)[0]
        n_keep = max(1, int(round(frac * len(idx))))
        keep.append(rng.permutation(idx)[:n_keep])
    keep = np.sort(np.concatenate(keep))
    return (_take(X, keep), y[keep], np.asarray(il)[keep],
            np.asarray(ll)[keep])


def _take(X, idx):
    """Rows ``idx`` of X: a tensor is indexed on its own device."""
    if torch.is_tensor(X):
        return X[torch.as_tensor(idx, device=X.device)]
    return np.asarray(X)[idx]


def _with_labels(X, y, T=None):
    """(X, labels) -> CTC tuple (X, labels, input_lens, label_lens). A
    tensor X stays where it is (float32); anything else becomes numpy."""
    n = len(X)
    T = X.shape[1] if T is None else T
    X = X.to(torch.float32) if torch.is_tensor(X) else np.asarray(
        X, np.float32)
    return (
        X,
        np.asarray(y, np.int32),
        np.full(n, T, np.int32),
        np.full(n, y.shape[1], np.int32),
    )


def _chance_labels(cfg: TrainCTCConfig, y: np.ndarray,
                   rng: np.random.Generator) -> np.ndarray:
    """Chance-context label null: permutation (train_ctc_rnn.py:155-158)
    or fresh random sequences (tune_ctc_rnn.py make_chance_labels)."""
    if cfg.chance_mode == "random":
        from cross_patient_speech_decoding_tpu_torch.utils.labels import (
            make_chance_labels,
        )

        return make_chance_labels(rng, len(y), y.shape[1], n_sil=cfg.n_sil)
    if cfg.chance_mode != "permute":
        raise ValueError(
            f"chance_mode must be 'permute' or 'random', got {cfg.chance_mode!r}"
        )
    return y[rng.permutation(len(y))]


def _class_ids(ys, device):
    """Sequence labels of every patient -> compact class ids on ``device``
    over their shared universe, and the universe's size."""
    enc = [encode_label_sequences(y) for y in ys]
    uni = np.unique(np.concatenate(enc))
    ids = [torch.as_tensor(to_class_ids(e, uni)[0], device=device)
           for e in enc]
    return ids, len(uni)


def _load_ctc_files(cfg: TrainCTCConfig, rng: np.random.Generator,
                    device=None):
    """Reference CTC ingestion from the HDF5 file (train_ctc_rnn.py:88-150).

    Target train/test from the file's split; optional stratified target
    subsample; pooled contexts load every ``train_pts`` patient (one-block
    patients train-only, others train and test), project through
    precomputed PCA/CCA transforms when ``pca_path`` is set, or fit PCA
    (+ CCA) on ``device`` otherwise.

    Returns (datasets, C, test): datasets[0] is the target train set.
    """
    from cross_patient_speech_decoding_tpu_torch.data.loaders import (
        apply_latent_xform,
        load_cca_xform,
        load_ctc_h5,
        load_pca_xform,
    )

    dev = resolve_device(device)
    tw_sel, tw_orig = _tuple_arg(cfg.tw_select), _tuple_arg(cfg.tw_orig)
    X_t, y_t, X_te, y_te = load_ctc_h5(
        cfg.data, cfg.target_pt, tw_sel, tw_orig, zscore=cfg.zscore,
        n_sil=cfg.n_sil,
    )
    if cfg.target_subsample < 1.0:
        # stratified train-size subsample by first phoneme (:104-116)
        keep = []
        for c in np.unique(y_t[:, 0]):
            idx = np.where(y_t[:, 0] == c)[0]
            n_keep = max(1, int(round(cfg.target_subsample * len(idx))))
            keep.append(rng.permutation(idx)[:n_keep])
        keep = np.concatenate(keep)
        X_t, y_t = X_t[keep], y_t[keep]

    if cfg.context == "chance":
        y_t = _chance_labels(cfg, y_t, rng)

    pooled = cfg.context in ("unaligned", "aligned")
    cross = []
    if pooled and cfg.train_pts:
        only_train_set = set(filter(None, cfg.only_train_pts.split(",")))
        for pt in cfg.train_pts.split(","):
            pt = pt.strip()
            if not pt or pt == cfg.target_pt:
                continue
            one_block = pt in only_train_set
            X_p, y_p, _, _ = load_ctc_h5(
                cfg.data, pt, tw_sel, tw_orig, zscore=cfg.zscore,
                only_train=one_block, load_all=not one_block,
                n_sil=cfg.n_sil,
            )
            cross.append((pt, X_p, y_p))

    if not pooled or not cross:
        datasets = [_with_labels(X_t, y_t)]
        return datasets, X_t.shape[-1], _with_labels(X_te, y_te)

    align_pt = cfg.align_pt or cfg.target_pt
    if cfg.pca_path:
        # precomputed offline transforms (tune_ctc_rnn.py:109-205)
        W_t = load_pca_xform(cfg.pca_path, cfg.target_pt)
        M_t = None
        if cfg.context == "aligned" and cfg.target_pt != align_pt:
            M_t = load_cca_xform(cfg.cca_path, align_pt, cfg.target_pt)
        lat_t = apply_latent_xform(X_t, W_t, M_t)
        lat_te = apply_latent_xform(X_te, W_t, M_t)
        lats = []
        for pt, X_p, y_p in cross:
            W_p = load_pca_xform(cfg.pca_path, pt)
            M_p = None
            if cfg.context == "aligned" and pt != align_pt:
                M_p = load_cca_xform(cfg.cca_path, align_pt, pt)
            lats.append((apply_latent_xform(X_p, W_p, M_p), y_p))
        if cfg.context == "unaligned":
            # truncate to common latent width (tune_ctc_rnn.py:197-205)
            min_dim = min([lat_t.shape[-1]] + [l.shape[-1] for l, _ in lats])
            lat_t, lat_te = lat_t[..., :min_dim], lat_te[..., :min_dim]
            lats = [(l[..., :min_dim], y) for l, y in lats]
        datasets = [_with_labels(lat_t, y_t)]
        datasets += [_with_labels(l, y) for l, y in lats]
        return datasets, lat_t.shape[-1], _with_labels(lat_te, y_te)

    # on-the-fly PCA (+ CCA for the aligned context), fit on train only
    def on_dev(X):
        return torch.as_tensor(X, dtype=torch.float32, device=dev)

    pca_t, lat_t = _pca_fit_lat(on_dev(X_t), None, cfg.n_components, MAX_K)
    lat_te = _pca_apply(pca_t, on_dev(X_te), MAX_K)
    cross_lats = [_pca_fit_lat(on_dev(X_p), None, cfg.n_components, MAX_K)[1]
                  for _, X_p, _ in cross]
    ids, n_cls = _class_ids([y_t] + [y_p for _, _, y_p in cross], dev)

    datasets = [_with_labels(lat_t, y_t)]
    for i, (lat, (_, _, y_p)) in enumerate(zip(cross_lats, cross)):
        if cfg.context == "aligned":
            lat = _cca_align_lat(lat_t, lat, ids[0], ids[i + 1], None, n_cls)
        datasets.append(_with_labels(lat, y_p))
    return datasets, MAX_K, _with_labels(lat_te, y_te)


def _prep_ctc_context(cfg: TrainCTCConfig, rng: np.random.Generator,
                      tar_train_mask=None, device=None):
    """Pool and align CTC data per context (select_datamodule analog).

    Returns (datasets, n_features, test): datasets[0] is the target train
    set; ``test`` is the file-defined held-out set (None for synthetic
    data, where the caller splits by mask).

    ``tar_train_mask`` (synthetic pooled contexts): (n_tar,) float mask of
    the iteration's target train rows. The target PCA and every CCA fit
    are restricted to it, so held-out trials never shape the pooled
    features; cross patients' own fits use all their rows.
    """
    if cfg.data != "synthetic":
        return _load_ctc_files(cfg, rng, device)

    dev = resolve_device(device)
    pts = _synthetic_ctc_cfg(cfg, dev)
    X_t, y_t, il_t, ll_t = pts[0]
    if cfg.context == "chance":
        y_t = _chance_labels(cfg, y_t, rng)
        return [(X_t, y_t, il_t, ll_t)], X_t.shape[-1], None

    if cfg.context == "patient":
        return [(X_t, y_t, il_t, ll_t)], X_t.shape[-1], None

    # pooled contexts: per-patient PCA to a common width
    mask = (None if tar_train_mask is None else
            torch.as_tensor(tar_train_mask, dtype=torch.float32, device=dev))
    lats = [_pca_fit_lat(X, mask if i == 0 else None, cfg.n_components,
                         MAX_K)[1]
            for i, (X, _, _, _) in enumerate(pts)]
    ids, n_cls = _class_ids([y for _, y, _, _ in pts], dev)

    out = []
    for i, lat in enumerate(lats):
        if cfg.context == "aligned" and i > 0:
            lat = _cca_align_lat(lats[0], lat, ids[0], ids[i], mask, n_cls)
        _, y, il, ll = pts[i]
        out.append((lat.to(torch.float32), y, il, ll))
    return out, MAX_K, None


_HPARAM_TO_CFG = {
    # reference tuned-hparam h5 keys -> config field (train_ctc_rnn.py:394-401)
    "learning_rate": "lr",
    "gclip_val": "clip",
    "hidden_size": "hidden",
    "n_layers": "n_layers",
    "dropout": "dropout",
    "l2_reg": "weight_decay",
}

_CONTEXT_NAMES = {
    # config context -> reference context string (train_ctc_rnn.py:404-412)
    "aligned": "aligned",
    "unaligned": "unaligned",
    "chance": "chance",
    "patient": "ptSpecific",
}


def _apply_tuned_hparams(cfg: TrainCTCConfig) -> TrainCTCConfig:
    """Overlay tuned hparams from a sweep output dir onto the config."""
    if not cfg.hparam_dir:
        return cfg
    from cross_patient_speech_decoding_tpu_torch.data.loaders import (
        load_tuned_hparams,
    )

    defaults = {k: getattr(cfg, f) for k, f in _HPARAM_TO_CFG.items()}
    tuned = load_tuned_hparams(
        cfg.hparam_dir, cfg.target_pt, _CONTEXT_NAMES[cfg.context], defaults
    )
    updates = {f: type(getattr(cfg, f))(tuned[k])
               for k, f in _HPARAM_TO_CFG.items()}
    return dataclasses.replace(cfg, **updates)


# ------------------------------------------------------------- persistence --

def _same_run_config(stored: dict, current: dict) -> bool:
    """True when a persisted results file belongs to this run's config.

    ``n_iter`` and ``out`` may differ (resuming with a larger iteration
    budget is the use case), as may the output and observability fields
    that cannot change results (``results_h5``, ``log_metrics``,
    ``log_format``, ``trace``) and the execution topology
    (``n_devices``). Anything else, e.g. another ``context`` writing to
    the same default path, must not resume.
    """
    skip = {"n_iter", "out", "results_h5", "log_metrics",
            "log_format", "trace", "n_devices"}
    keys = (set(stored) | set(current)) - skip
    return all(stored.get(k) == current.get(k) for k in keys)


# set-aside copies kept per results file name: repeated mismatched reruns
# leave a bounded footprint while the newest few survive
STALE_KEEP = 10

_STALE_STAMP = r"\d{8}-\d{6}(?:\.\d+)?_"


def _stale_copies(stale_dir: Path, name: str):
    """The set-asides of results file ``name`` in ``stale_dir``: exactly
    ``{timestamp}_{name}`` or ``{timestamp}.{n}_{name}``. (The JAX package
    globs ``*_{name}``, which also matches set-asides of a sibling stem
    such as ``x_ctc.pkl`` beside ``ctc.pkl``, and then prunes them.)"""
    pat = re.compile(_STALE_STAMP + re.escape(name))
    return [f for f in stale_dir.iterdir()
            if f.is_file() and pat.fullmatch(f.name)]


def _set_aside_stale(p: Path) -> Path:
    """Move a config-mismatched results file into the ``_stale/`` sidecar
    next to it (timestamped, collision-safe), then prune that file's
    set-asides to the newest :data:`STALE_KEEP`."""
    stale_dir = p.parent / "_stale"
    stale_dir.mkdir(parents=True, exist_ok=True)
    ts = time.strftime("%Y%m%d-%H%M%S")
    stale = stale_dir / f"{ts}_{p.name}"
    n = 1
    while stale.exists():
        stale = stale_dir / f"{ts}.{n}_{p.name}"
        n += 1
    p.rename(stale)
    # rename keeps the file's mtime, so this orders by when each store
    # was last written (ns resolution breaks same-second ties)
    olds = sorted(_stale_copies(stale_dir, p.name),
                  key=lambda f: f.stat().st_mtime_ns)
    for f in olds[:-STALE_KEEP]:
        f.unlink()
    return stale


def _completed_results(out_path: str, params: dict, scalar: bool = True,
                       set_aside: bool = True):
    """Per-iteration results already persisted, for kill-and-resume.

    The incremental results pickle is the manifest. A file written by a
    different config is set aside (:func:`_set_aside_stale`) so stale
    results never pass for this run's; ``set_aside=False`` makes the check
    read-only (mismatches return [] and the file stays).
    """
    if not out_path:
        return []
    p = Path(out_path)
    if not p.is_file():
        return []
    store = load_pkl(p)
    if not _same_run_config(store.get("params", {}), params):
        if not set_aside:
            return []
        stale = _set_aside_stale(p)
        print(f"config mismatch: prior results moved to {stale}", flush=True)
        return []
    accs = store.get("accs", [])
    if scalar:
        return [float(np.asarray(a).ravel()[0]) for a in accs]
    return [np.asarray(a) for a in accs]


# ----------------------------------------------------------- augmentation --

_CTC_AUGS = (
    "time_warping", "time_masking", "time_shifting", "noise_jitter",
    "scaling",
)


def _parse_augmentations(spec: str):
    """training.augmentations YAML list analog: '' = none, 'all' = the
    reference default (all five transforms, train_ctc_rnn_config.yaml)."""
    if not spec:
        return ()
    names = _CTC_AUGS if spec == "all" else tuple(
        s.strip() for s in spec.split(",") if s.strip()
    )
    bad = [n for n in names if n not in _CTC_AUGS]
    if bad:
        raise ValueError(f"unknown augmentations {bad}; pick from {_CTC_AUGS}")
    return names


def _augment_stack(x, names, generator):
    """[x, aug1(x), aug2(x), ...] concatenated on the trial axis; each
    transform sees the original tensor (the reference datamodules' concat
    semantics, realtime_datamodule.py:239-244)."""
    from cross_patient_speech_decoding_tpu_torch.ops import augment

    return torch.cat([x] + [getattr(augment, name)(generator, x)
                            for name in names])


def _apply_ctc_augmentations(train_batch, names, generator):
    """Augmented copies of the pooled CTC train set; labels and lengths
    repeat."""
    x, y, il, ll = train_batch
    reps = len(names) + 1
    return (_augment_stack(x, names, generator), torch.cat([y] * reps),
            torch.cat([il] * reps), torch.cat([ll] * reps))


# ----------------------------------------------------------- observability --

def _run_log_path(out: str, run_name: str, it: int, fold: int | None = None,
                  fmt: str = "csv"):
    """Per-epoch metrics log path next to the results file:
    ``logs/{run_name}/iter{it:03d}[_fold{k:02d}].{csv|jsonl}``, or for
    ``tb`` a run directory. Called only for iterations about to run, so a
    file already there is an earlier run's and is removed."""
    if not out:
        return None
    d = Path(out).parent / "logs" / run_name
    stem = f"iter{it:03d}" + ("" if fold is None else f"_fold{fold:02d}")
    if fmt == "tb":
        run_dir = d / stem
        if run_dir.is_dir():
            for old_ev in run_dir.glob("events.out.tfevents.*"):
                old_ev.unlink()
        return str(run_dir)
    p = d / (stem + (".jsonl" if fmt == "jsonl" else ".csv"))
    if p.exists():
        p.unlink()
    return str(p)


def _maybe_trace(enabled: bool, out: str, run_name: str):
    """``torch.profiler`` trace of the first executed iteration
    (``trace=true``), under ``trace/{run_name}`` beside the results file."""
    if not enabled:
        return contextlib.nullcontext()
    from cross_patient_speech_decoding_tpu_torch.utils.profiling import trace

    d = Path(out or "results").parent / "trace" / run_name
    d.mkdir(parents=True, exist_ok=True)
    return trace(str(d))


# --------------------------------------------------------------- train ctc --

def _init_model(cfg: TrainCTCConfig, in_channels: int, it: int, device):
    """Iteration ``it``'s model, initial weights from seed ``cfg.seed +
    it`` (the JAX driver's ``model.init(jax.random.key(seed + it))``)."""
    from cross_patient_speech_decoding_tpu_torch.models import RealtimeRNN

    return RealtimeRNN(in_channels, cfg.hidden, cfg.n_layers, 11,
                       dropout=cfg.dropout, win_size=cfg.win_size,
                       stride=cfg.stride, seed=cfg.seed + it, device=device)


def _on(a, dev):
    """A tensor or a numpy array as a tensor on ``dev``."""
    return a.to(dev) if torch.is_tensor(a) else torch.as_tensor(
        np.asarray(a), device=dev)


def run_train_ctc(cfg: TrainCTCConfig, verbose: bool = True, device=None):
    """CTC training and test for one context; returns the test PER of each
    iteration, as numpy.

    Runs on ``device`` (default: the first CUDA card; raises without one
    unless ``device='cpu'``). File-backed runs (``data=<path.h5>``) follow
    the reference pipeline: h5 ingestion and pooling, tuned-hparam
    override, per-iteration incremental persistence to ``out``, and resume
    (completed iterations are skipped on restart).

    ``n_devices > 0`` trains data-parallel on that many ranks
    (``parallel.make_padded_sharded_ctc_train_step``): each rank prepares
    the same data, trains on its block of every mini-batch, and the
    gradients are summed over the ranks. Called outside a process group,
    the driver launches the ranks itself (``device`` as
    ``parallel.mesh.rank_devices`` reads it) and returns rank 0's PERs;
    only rank 0 writes files. At dropout 0 the PERs are the one-device
    run's up to the order of the gradient sums; the dropout masks of rank
    r > 0 come from a generator of its own.
    """
    from cross_patient_speech_decoding_tpu_torch.parallel import (
        make_padded_sharded_ctc_train_step,
    )
    from cross_patient_speech_decoding_tpu_torch.train import (
        create_train_state,
        make_ctc_eval_step,
        make_ctc_train_step,
    )
    from cross_patient_speech_decoding_tpu_torch.train.loops import (
        fit as fit_loop,
        make_optimizer,
    )

    if needs_launch(cfg.n_devices):
        return launch_driver(run_train_ctc, cfg.n_devices, device, cfg,
                             verbose)
    mesh, dev = mesh_and_device(cfg.n_devices, device)
    writes = is_writer(mesh)
    verbose = verbose and writes
    cfg = _apply_tuned_hparams(cfg)
    init_sd = None
    if cfg.init_ckpt:
        # fine-tune a reference-trained model: the architecture from the
        # checkpoint, its weights the warm start of every iteration
        from cross_patient_speech_decoding_tpu_torch.models.torch_import \
            import realtime_rnn_from_ckpt

        ck_model = realtime_rnn_from_ckpt(cfg.init_ckpt, device=dev)
        if ck_model.bidirectional:
            # the JAX driver builds a unidirectional model and fails at
            # its first apply on the (2 n_layers, 1, H) h0; say why here
            raise ValueError(
                "init_ckpt holds a bidirectional RealtimeRNN; train-ctc "
                "trains the unidirectional (streaming) model"
            )
        if ck_model.n_classes != 11:
            raise ValueError(
                f"checkpoint has {ck_model.n_classes} classes; the CTC "
                "phoneme task uses 11 (blank + 9 phonemes + sil)"
            )
        cfg.hidden, cfg.n_layers = ck_model.hidden, ck_model.n_layers
        cfg.win_size, cfg.stride = ck_model.win_size, ck_model.stride
        init_sd = ck_model.state_dict()
        del ck_model
    if writes and cfg.results_h5 and not (cfg.save_logits and cfg.out):
        # the reference's save_results writes `logits` unconditionally
        # (train_ctc_rnn.py:448-491): warn before training, not after
        print(
            "WARNING: results_h5 is set but logits will be OMITTED from "
            "the h5 (needs save_logits=true and a results pkl via out=); "
            "reference notebooks reading f['logits'] will fail on it",
            flush=True,
        )
    done = from_rank0(lambda: _completed_results(cfg.out, vars(cfg)), mesh)
    pers = list(done[: cfg.n_iter])
    if pers and verbose:
        print(f"resuming: {len(pers)}/{cfg.n_iter} iterations already done",
              flush=True)
    if cfg.out and writes:
        Path(cfg.out).parent.mkdir(parents=True, exist_ok=True)
    run_name = f"{cfg.target_pt}_{_CONTEXT_NAMES[cfg.context]}_ctcRnn"
    start_it = len(pers)

    # prep depends on the iteration's rng only for chance labels and the
    # target subsample, and synthetic pooled contexts fit the target PCA
    # and CCA on each iteration's train rows; otherwise prepare once
    synth_pooled = (
        cfg.data == "synthetic" and cfg.context in ("aligned", "unaligned")
    )
    prep_invariant = (
        cfg.context != "chance" and cfg.target_subsample >= 1.0
        and not synth_pooled
    )
    prep_cache = None
    if prep_invariant and len(pers) < cfg.n_iter:
        prep_cache = _prep_ctc_context(cfg, np.random.default_rng(cfg.seed),
                                       device=dev)
    n_tar = _synthetic_ctc_n_trials(cfg) if synth_pooled else None
    tx = make_optimizer(cfg.lr, cfg.weight_decay, cfg.decay_steps,
                        clip=cfg.clip)
    aug_names = _parse_augmentations(cfg.augmentations)

    for it in range(len(pers), cfg.n_iter):
        # per-iteration generator so resumed runs are deterministic
        rng = np.random.default_rng(cfg.seed + 7919 * it)
        if synth_pooled:
            # split first (prep draws nothing here), then fit the
            # target-side PCA and CCA on the train rows only
            tr, va, te = train_val_test_masks(
                n_tar, rng, cfg.val_frac, cfg.test_frac
            )
            datasets, C, test = _prep_ctc_context(
                cfg, rng, tar_train_mask=tr, device=dev
            )
            te_i = np.where(te > 0)[0]
        else:
            datasets, C, test = (
                prep_cache if prep_cache is not None
                else _prep_ctc_context(cfg, rng, device=dev)
            )
            n = len(datasets[0][0])
            if test is None:
                tr, va, te = train_val_test_masks(
                    n, rng, cfg.val_frac, cfg.test_frac
                )
                te_i = np.where(te > 0)[0]
            else:
                tr, va, _ = train_val_test_masks(n, rng, cfg.val_frac, 0.0)
                te_i = None
        tar = datasets[0]
        tr_i, va_i = np.where(tr > 0)[0], np.where(va > 0)[0]

        def batch(idx):
            return tuple(_on(_take(a, idx), dev) for a in tar)

        train_batch = batch(tr_i)
        if len(datasets) > 1:  # append the pooled cross data to train
            cross_sets = datasets[1:]
            if cfg.cross_subsample < 1.0:
                # fig_5 data-scaling axis: per-iteration stratified
                # subsample of each cross patient's pooled trials
                cross_sets = [
                    _subsample_ctc_set(d, cfg.cross_subsample, rng)
                    for d in cross_sets
                ]
            train_batch = tuple(
                torch.cat([train_batch[j]] + [_on(d[j], dev)
                                              for d in cross_sets])
                for j in range(4))

        test_batch = batch(te_i) if test is None else tuple(
            _on(a, dev) for a in test)

        if aug_names:
            gen_aug = torch.Generator(device=dev).manual_seed(
                cfg.seed + 500 + it)
            train_batch = _apply_ctc_augmentations(train_batch, aug_names,
                                                   gen_aug)

        model = _init_model(cfg, train_batch[0].shape[-1], it, dev)
        if init_sd is not None:
            want = init_sd["rnn.fwd0.wi"].shape[0]
            have = train_batch[0].shape[-1] * cfg.win_size
            if want != have:
                raise ValueError(
                    f"checkpoint input width {want} != data width {have} "
                    f"({train_batch[0].shape[-1]} channels x win "
                    f"{cfg.win_size}); match n_components / channel "
                    "selection to the checkpoint's training setup"
                )
            model.load_state_dict(init_sd)
        state = create_train_state(model, tx)
        gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1000 + it)
        with _maybe_trace(cfg.trace and it == start_it and writes, cfg.out,
                          run_name):
            res = fit_loop(
                state,
                make_ctc_train_step(model, tx) if mesh is None
                else make_padded_sharded_ctc_train_step(model, tx, mesh),
                make_ctc_eval_step(model),
                train_batch,
                batch(va_i),
                epochs=cfg.epochs,
                generator=gen,
                monitor="per",
                mode="min",
                batch_size=cfg.batch_size or None,
                eval_every=max(1, cfg.epochs // 30),
                log_path=(
                    _run_log_path(cfg.out, run_name, it,
                                  fmt=cfg.log_format)
                    if cfg.log_metrics and writes else None
                ),
                log_format=cfg.log_format,
            )
        best = res.best_state.model
        per = float(make_ctc_eval_step(best)(test_batch)["per"])
        if cfg.decode == "beam":
            per = _beam_rescore_per(best, test_batch, cfg)
        pers.append(per)
        extra = None
        if cfg.save_logits:
            # per-iteration test log-probs, the reference results-h5
            # 'logits' dataset (train_ctc_rnn.py:215-224, 483)
            extra = {"logits": _test_log_probs(best, test_batch[0])}
        if cfg.out and writes:
            append_results_pkl(cfg.out, np.asarray([per]), params=vars(cfg),
                               extra=extra)
        if verbose:
            print(f"iter {it} [{cfg.context}]: test PER {per:.1f}%", flush=True)
        del res, state, model, best, train_batch
    if cfg.results_h5 and writes:
        _write_results_h5(cfg, pers)
    return np.asarray(pers)


def _test_log_probs(model, x) -> np.ndarray:
    """log-softmax of the model's logits (eval mode) as float32 numpy."""
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            lp = torch.log_softmax(model(x), dim=-1)
    finally:
        model.train(was_training)
    return lp.cpu().numpy()


def _write_results_h5(cfg: TrainCTCConfig, pers) -> None:
    """The reference's results-h5 layout (train_ctc_rnn.py:448-491); the
    logits come from the incremental pkl when they were saved."""
    from cross_patient_speech_decoding_tpu_torch.data.loaders import (
        save_ctc_results_h5,
    )
    from cross_patient_speech_decoding_tpu_torch.utils.labels import PHON_DICT

    logits = None
    if cfg.save_logits and cfg.out and Path(cfg.out).exists():
        # extras append in lockstep with accs: the first len(pers) are the
        # iterations reported (the pkl may hold more after a resume with
        # a smaller n_iter)
        ex = load_pkl(cfg.out).get("extra", [])[: len(pers)]
        if len(ex) == len(pers) and all(e and "logits" in e for e in ex):
            logits = np.stack([e["logits"] for e in ex])
    save_ctc_results_h5(
        cfg.results_h5, np.asarray(pers), logits, PHON_DICT,
        model_hparams={
            "hidden_size": cfg.hidden, "n_layers": cfg.n_layers,
            "dropout": cfg.dropout, "learning_rate": cfg.lr,
            "l2_reg": cfg.weight_decay, "win_size": cfg.win_size,
            "stride": cfg.stride,
        },
    )


def _beam_rescore_per(model, batch, cfg) -> float:
    """Test PER with prefix beam search on the host (the reference's
    ctc_decoder.py beam path; C++ through ``realtime.beam``, Python where
    the library cannot be built)."""
    from cross_patient_speech_decoding_tpu_torch.models import (
        adjusted_input_lengths,
    )
    from cross_patient_speech_decoding_tpu_torch.realtime.beam import (
        edit_distance_batch,
        prefix_beam_search,
    )

    x, labels, input_lens, label_lens = batch
    lp = _test_log_probs(model, x)
    in_adj = adjusted_input_lengths(input_lens, cfg.win_size,
                                    cfg.stride).cpu().numpy()
    labels, label_lens = labels.cpu().numpy(), label_lens.cpu().numpy()
    preds, pred_lens = [], []
    max_len = lp.shape[1]
    for i in range(lp.shape[0]):
        seq, _ = prefix_beam_search(lp[i, : in_adj[i]], cfg.beam_size)
        seq = list(seq)[:max_len]
        preds.append(seq + [0] * (max_len - len(seq)))
        pred_lens.append(len(seq))
    dists = edit_distance_batch(
        np.asarray(preds, np.int32), np.asarray(pred_lens, np.int32),
        np.asarray(labels, np.int32), np.asarray(label_lens, np.int32),
    )
    return float(dists.sum() / max(1, int(label_lens.sum())) * 100.0)


# ------------------------------------------------------------- svm decode --

def _build_patient_arrays(Xs, ys, aligns, device):
    """Encode labels to shared class ids and wrap per-patient
    ``PatientArrays`` on ``device`` (numpy or tensor X alike).

    Returns (pts, n_classes, n_align_classes)."""
    from cross_patient_speech_decoding_tpu_torch.decoders.pooled import (
        PatientArrays,
    )

    y_enc = [encode_label_sequences(np.asarray(y)) for y in ys]
    y_uni = np.unique(np.concatenate(y_enc))
    a_enc = [encode_label_sequences(np.asarray(a)) for a in aligns]
    a_uni = np.unique(np.concatenate(a_enc))

    def ids(enc, uni):
        return torch.as_tensor(to_class_ids(enc, uni)[0], dtype=torch.int64,
                               device=device)

    pts = [
        PatientArrays(X=torch.as_tensor(X, dtype=torch.float32,
                                        device=device),
                      y=ids(ye, y_uni), y_align=ids(ae, a_uni))
        for X, ye, ae in zip(Xs, y_enc, a_enc)
    ]
    return pts, len(y_uni), len(a_uni)


def patients_from_config(data: str, target_pt: str, p_ind: int = -1,
                         lab_type: str = "phon", algn_type: str = "phon_seq",
                         seed: int = 0, random_data: bool = False,
                         noise: float = 0.6, trials_per_class: int = 15,
                         n_patients: int = 4, T: int = 40,
                         return_names: bool = False, device=None):
    """(tar, cross, n_classes, n_align_classes) ``PatientArrays`` from a
    decoding-data pkl or synthetic data made on ``device`` (the first CUDA
    card by default); with ``return_names`` also the patient names, target
    first (for file data the pkl's ``pre_pts`` order)."""
    dev = resolve_device(device)
    if data == "synthetic":
        chans = (96, 111, 80, 64, 128, 72, 56, 104)[:n_patients]
        ds = make_synthetic_patients_device(
            seed=seed, n_patients=n_patients, n_classes=9,
            trials_per_class=trials_per_class, T=T, channels=chans,
            latent_dim=10, noise=noise, device=dev)
        Xs, ys, aligns = ds.X, ds.y_first, ds.y_seq
        names = [f"synthetic{i}" for i in range(n_patients)]
    else:
        from cross_patient_speech_decoding_tpu_torch.data.loaders import (
            decoding_data_from_dict,
        )

        pt_data = load_pkl(data)
        (X_t, y_t, ya_t), pre = decoding_data_from_dict(
            pt_data, target_pt, p_ind, lab_type, algn_type)
        Xs = [X_t] + [x for x, _, _ in pre]
        ys = [y_t] + [y for _, y, _ in pre]
        aligns = [ya_t] + [ya for _, _, ya in pre]
        names = [target_pt] + list(pt_data[target_pt]["pre_pts"])

    rng = np.random.default_rng(seed)
    if random_data:  # -r control: destroy cross-patient structure
        Xs = [Xs[0]] + [rng.random(tuple(x.shape)).astype(np.float32)
                        for x in Xs[1:]]

    pts, n_y, n_a = _build_patient_arrays(Xs, ys, aligns, dev)
    if return_names:
        return pts[0], tuple(pts[1:]), n_y, n_a, names
    return pts[0], tuple(pts[1:]), n_y, n_a


def apply_pool_filters(cross, cross_names, pool_train: bool, pooled_pts: str):
    """The cross patients to pool: none with ``pool_train=False`` (the
    reference's single-patient branch), else all, or the named subset of
    ``pooled_pts`` in the user's order. Returns (cross, cross_names)."""
    if not pool_train:
        return (), ()
    if pooled_pts in ("", "all"):
        return tuple(cross), tuple(cross_names)
    want = [p.strip() for p in pooled_pts.split(",") if p.strip()]
    missing = [p for p in want if p not in cross_names]
    if missing:
        raise ValueError(
            f"pooled_pts {missing} not among cross patients "
            f"{list(cross_names)}")
    return tuple(cross[list(cross_names).index(p)] for p in want), tuple(want)


def _prediction_records(y_host, preds, test_masks):
    """(y_true, y_pred, wrong_trs) of one iteration in the reference's
    order: folds in turn, each fold's test rows ascending; ``wrong_trs``
    are the target-trial indices of the mispredicted test rows."""
    y_true, y_pred, wrong = [], [], []
    for f in range(test_masks.shape[0]):
        idx = np.where(test_masks[f] > 0)[0]
        yt = y_host[idx]
        yp = np.asarray(preds[f])[idx]
        y_true.append(yt)
        y_pred.append(yp)
        wrong.append(idx[yt != yp])
    return (np.concatenate(y_true), np.concatenate(y_pred),
            np.concatenate(wrong))


def run_svm_decode(cfg: SVMDecodeConfig, verbose: bool = True, device=None):
    """Repeated stratified-CV pooled decode (``cpsd svm-decode``) with
    incremental pkl persistence; returns the (n_iter, n_folds) balanced
    accuracies as numpy.

    Each iteration splits the target with its own seed and decodes all its
    folds in batches of ``fold_batch`` (``iter_batch`` iterations' folds
    stacked into one batch of rows), or, with ``nested``, runs the
    per-outer-fold TPE search. A rerun with the same ``out`` resumes after
    the iterations stored there. Controls: ``chance`` permutes the
    target's labels, ``random_data`` replaces the cross patients' data
    with uniform noise, ``surrogate='tme'`` with TME max-ent surrogates
    (supp_fig_11; each fitted on the run's device) and
    ``surrogate='shuffle'`` with mode-shuffle surrogates. ``device`` is
    the first CUDA card by default.

    ``n_devices > 0`` shards the folds over that many ranks (fixed
    parameters: ``make_cv_decoder(mesh=)``; nested: the outer folds of
    ``nested_cv_decode_bayes(mesh=)``): each rank prepares the same data,
    decodes its block of folds and gathers the rest. Called outside a
    process group, the driver launches the ranks itself and returns rank
    0's accuracies; only rank 0 writes ``out``.
    """
    from cross_patient_speech_decoding_tpu_torch.data.splits import (
        repeated_stratified_kfold_masks,
        stratified_train_subsample_masks,
    )
    from cross_patient_speech_decoding_tpu_torch.decoders.nested_cv import (
        nested_cv_decode_bayes,
    )
    from cross_patient_speech_decoding_tpu_torch.decoders.pooled import (
        DecodeConfig,
        PatientArrays,
        make_cv_decoder,
    )

    if needs_launch(cfg.n_devices):
        return launch_driver(run_svm_decode, cfg.n_devices, device, cfg,
                             verbose)
    mesh, dev = mesh_and_device(cfg.n_devices, device)
    writes = is_writer(mesh)
    verbose = verbose and writes
    tar, cross, n_y, n_a, names = patients_from_config(
        cfg.data, cfg.target_pt, cfg.p_ind, cfg.lab_type, cfg.algn_type,
        cfg.seed, cfg.random_data, trials_per_class=cfg.synth_trials,
        n_patients=cfg.synth_patients, T=cfg.synth_T, return_names=True,
        device=dev)
    cross, _ = apply_pool_filters(cross, names[1:], cfg.pool_train,
                                  cfg.pooled_pts)
    rng_ctl = np.random.default_rng(cfg.seed + 777)
    if cfg.chance:
        perm = torch.as_tensor(rng_ctl.permutation(len(tar.y)), device=dev)
        tar = PatientArrays(X=tar.X, y=tar.y[perm], y_align=tar.y_align[perm])
    if cfg.surrogate != "none":
        from cross_patient_speech_decoding_tpu_torch.data.surrogates import (
            mode_shuffle_surrogate,
            tme_surrogate,
        )

        new_cross = []
        for c in cross:
            if cfg.surrogate == "tme":
                Xs, _ = tme_surrogate(c.X, steps=1000, seed=cfg.seed,
                                      device=dev)
            else:
                # rng_ctl after chance's permutation, as in the JAX driver
                Xs = mode_shuffle_surrogate(c.X, rng_ctl)
            new_cross.append(PatientArrays(X=Xs, y=c.y, y_align=c.y_align))
        cross = tuple(new_cross)
    dcfg = DecodeConfig(
        n_comp=cfg.n_comp, max_k=cfg.max_k, n_classes=n_y,
        n_align_classes=n_a, lam=cfg.lam, kernel=cfg.kernel,
        # single-patient mode trains on the target by definition
        tar_in_train=cfg.tar_in_train or not cfg.pool_train,
        bagging=cfg.bagging, seed=cfg.seed,
    )
    y_host = tar.y.cpu().numpy()

    if writes:
        Path(cfg.out).parent.mkdir(parents=True, exist_ok=True)
    all_accs = from_rank0(lambda: _completed_results(
        cfg.out, vars(cfg), scalar=False), mesh)[: cfg.n_iter]
    if all_accs and verbose:
        print(f"resuming: {len(all_accs)}/{cfg.n_iter} iterations done",
              flush=True)

    if cfg.nested:
        for it in range(len(all_accs), cfg.n_iter):
            out = nested_cv_decode_bayes(
                tar, cross, dcfg, n_folds=cfg.n_folds,
                n_rounds=cfg.nested_rounds, n_points=cfg.nested_points,
                n_inner=cfg.nested_inner, strategy=cfg.strategy,
                seed=cfg.seed + 104729 * it,
                train_frac=cfg.trial_subsample,
                return_preds=cfg.save_preds,
                mesh=mesh,
            )
            extra = {}
            if cfg.save_preds:
                accs, hp_best, preds, te = out
                yt, yp, wr = _prediction_records(y_host, preds, te)
                extra.update(y_true=yt, y_pred=yp, wrong_trs=wr)
            else:
                accs, hp_best = out
            extra.update({k: v.cpu().numpy() for k, v in hp_best.items()})
            all_accs.append(accs)
            if writes:
                append_results_pkl(cfg.out, accs, params=vars(cfg),
                                   extra=extra)
            if verbose:
                print(f"iter {it} [nested]: balanced acc {accs.mean():.3f} "
                      f"(chance {1.0 / n_y:.3f})", flush=True)
        return np.stack(all_accs)

    decoder = make_cv_decoder(cfg.strategy, dcfg, fold_batch=cfg.fold_batch,
                              mesh=mesh, return_preds=cfg.save_preds)
    ib = max(1, cfg.iter_batch)
    it = len(all_accs)
    while it < cfg.n_iter:
        k = min(ib, cfg.n_iter - it)
        pairs = [
            repeated_stratified_kfold_masks(y_host, cfg.n_folds, 1,
                                            seed=cfg.seed + it + j)
            for j in range(k)
        ]
        if cfg.trial_subsample < 1.0:
            # -tss, seeded per iteration: the same masks at any iter_batch
            # and across a resume
            pairs = [
                (stratified_train_subsample_masks(
                    p[0], y_host, cfg.trial_subsample,
                    np.random.default_rng(cfg.seed + 3571 * (it + j + 1))),
                 p[1])
                for j, p in enumerate(pairs)
            ]
        tr = np.concatenate([p[0] for p in pairs], axis=0)
        te = np.concatenate([p[1] for p in pairs], axis=0)
        out = decoder(tar, cross,
                      torch.as_tensor(tr, dtype=torch.float32, device=dev),
                      torch.as_tensor(te, dtype=torch.float32, device=dev))
        if cfg.save_preds:
            accs_all, preds_all = out[0].cpu().numpy(), out[1].cpu().numpy()
        else:
            accs_all, preds_all = out.cpu().numpy(), None
        for j in range(k):
            sl = slice(j * cfg.n_folds, (j + 1) * cfg.n_folds)
            accs = accs_all[sl]
            all_accs.append(accs)
            extra = None
            if preds_all is not None:
                yt, yp, wr = _prediction_records(y_host, preds_all[sl], te[sl])
                extra = {"y_true": yt, "y_pred": yp, "wrong_trs": wr}
            if writes:
                append_results_pkl(cfg.out, accs, params=vars(cfg),
                                   extra=extra)
            if verbose:
                print(f"iter {it + j}: balanced acc {accs.mean():.3f} "
                      f"(chance {1.0 / n_y:.3f})", flush=True)
        it += k
    return np.stack(all_accs)


# ---------------------------------------------------------- train seq2seq --

# latent width of the seq2seq driver's PCA and CCA: ops.jacobi.ANY_BATCH_K,
# so on the card each source's batched chol CCA fit is one Jacobi launch
S2S_MAX_K = 24
S2S_CHANNELS = (64, 72, 56, 96, 111, 128, 80, 104)
S2S_N_CLASSES = 9  # phoneme digits 1-9, minus 1


def _seq2seq_arrays(cfg: TrainSeq2SeqConfig, device=None):
    """(Xs, y_seq_raw) per patient, target first: X (N, T, C) float32
    tensors on the device and the (N, 3) label sequences (digits 1-9) as
    numpy. Synthetic data is made on the device (9 sequence classes x
    ``synth_trials`` trials a patient). A ``pt_decoding_data*.pkl`` is read
    as train_seq2seq.py:78-96 reads it: ``decoding_data_from_dict`` with
    ``p_ind``, the targets the full phoneme sequences, the ``pre_pts``
    pooled when ``pooled`` is set."""
    dev = resolve_device(device)
    if cfg.data == "synthetic":
        ds = make_synthetic_patients_device(
            seed=cfg.seed, n_patients=cfg.synth_patients, n_classes=9,
            trials_per_class=cfg.synth_trials, T=cfg.synth_T,
            channels=S2S_CHANNELS[: cfg.synth_patients], latent_dim=10,
            noise=0.5, device=dev)
        Xs, ys = ds.X, ds.y_seq
    else:
        from cross_patient_speech_decoding_tpu_torch.data.loaders import (
            decoding_data_from_dict,
        )

        (X_t, _, ya_t), pre = decoding_data_from_dict(
            load_pkl(cfg.data), cfg.target_pt, cfg.p_ind, cfg.lab_type,
            cfg.algn_type)
        Xs, ys = [X_t], [ya_t]
        if cfg.pooled:
            Xs += [X for X, _, _ in pre]
            ys += [ya for _, _, ya in pre]
    return ([torch.as_tensor(X, dtype=torch.float32, device=dev).contiguous()
             for X in Xs], [np.asarray(y) for y in ys])


def _seq2seq_pca(X, mask, max_k: int):
    """A patient's PCA latents at 0.9 explained variance: (N, T, K), or
    (F, N, T, K) fitted on the trials of each row of an (F, N) mask, each
    component's sign fixed by ``decoders.pooled._pca_latents``' rule."""
    from cross_patient_speech_decoding_tpu_torch.decoders.pooled import (
        _pca_latents,
    )

    return _pca_latents(X, 0.9, max_k, mask)[1]


def _seq2seq_align(lat_t, lat_s, ids_t, ids_s, n_classes: int, mask):
    """A source's latents (Ns, T, K) mapped into the target's space by
    class-averaged chol CCA, fitted on the target rows of ``mask``: one
    fit batched over the mask's leading (fold) dims, lat_t (..., N0, T, K).
    Returns (..., Ns, T, K)."""
    from cross_patient_speech_decoding_tpu_torch.ops.cca import (
        fit_cca_aligner,
        transform_b_to_a,
    )

    lead = tuple(mask.shape[:-1])
    al = fit_cca_aligner(lat_t, lat_s.expand(lead + lat_s.shape),
                         ids_t.expand(lead + ids_t.shape),
                         ids_s.expand(lead + ids_s.shape), n_classes,
                         mask_a=mask)
    Ns, T, K = lat_s.shape
    return transform_b_to_a(al, lat_s.reshape(Ns * T, K)).reshape(
        lead + (Ns, T, -1))


def _seq2seq_fold_features(tarX, cross_lats, ids, n_classes: int, masks,
                           max_k: int = S2S_MAX_K):
    """[target latents, aligned cross latents...] of the folds of (F, N0)
    train masks (or of one fold's (N0,) mask). The target PCA and every CCA
    fit are refitted on the fold's train rows only (the reference's
    per-fold process_aligner, datamodules.py:470-472), so held-out trials
    never shape the pooled features; the cross patients' own latents
    (``cross_lats``) are fitted once a run, on all their rows. Without
    cross patients: the raw target channels, shared by every fold (the
    reference's SimpleMicroDataModule path, train_seq2seq.py:110-116)."""
    if not cross_lats:
        return [tarX]
    lat_t = _seq2seq_pca(tarX, masks, max_k)
    return [lat_t] + [
        _seq2seq_align(lat_t, lat, ids[0], ids[p], n_classes, masks)
        for p, lat in enumerate(cross_lats, start=1)]


def _augment_stack_folds(x, names, generator):
    """:func:`_augment_stack` over (F, N, T, C) per-fold stacks: the copies
    concatenated on the trial axis (1), each fold's rows drawn
    independently."""
    from cross_patient_speech_decoding_tpu_torch.ops import augment

    n_folds, N, T, C = x.shape
    flat = x.reshape(n_folds * N, T, C)
    return torch.cat([x] + [
        getattr(augment, name)(generator, flat).reshape(n_folds, N, T, C)
        for name in names], dim=1)


def _augmented_fold_masks(tr_m, te_m, reps: int):
    """(train, test) masks over the target rows followed by their
    ``reps - 1`` augmented copies: the copies of train rows train, the
    copies of test rows are in neither set."""
    return (np.tile(tr_m, (1, reps)),
            np.concatenate([te_m, np.zeros((te_m.shape[0],
                                            te_m.shape[1] * (reps - 1)))],
                           axis=1))


def _seq2seq_model(cfg: TrainSeq2SeqConfig):
    """The run's model: ``model(in_channels, seed=, device=)`` makes a
    ``Seq2SeqRNN`` at the config's widths, 9 classes, default dropouts."""
    from cross_patient_speech_decoding_tpu_torch.models import Seq2SeqRNN

    return functools.partial(
        Seq2SeqRNN, n_filters=cfg.n_filters, hidden=cfg.hidden,
        num_classes=S2S_N_CLASSES, n_enc_layers=cfg.n_enc_layers,
        n_dec_layers=cfg.n_dec_layers, kernel_size=cfg.kernel_size)


def _build_libraries(dev, beam: bool = False) -> None:
    """Build what a run on ``dev`` loads at first use: the CUDA kernel
    libraries on a card, and with ``beam`` the native beam search (which
    falls back to Python where it cannot be built)."""
    if dev.type == "cuda":
        from cross_patient_speech_decoding_tpu_torch.ops import _ext

        _ext.build()
        _ext.lib()
    if beam:
        from cross_patient_speech_decoding_tpu_torch.realtime import (
            beam as native_beam,
        )

        native_beam.native_available()


class _Seq2SeqPrep(NamedTuple):
    """What every iteration of a seq2seq run shares: the target's raw
    trials, the cross patients' latents (fitted once a run), the class ids
    of the CCA fits and the stratification, and the labels (digit - 1)."""

    tarX: torch.Tensor
    cross_lats: list
    ids: list
    n_classes: int
    strat: np.ndarray
    y_seqs: list


def _seq2seq_prep(cfg: TrainSeq2SeqConfig, dev) -> _Seq2SeqPrep:
    Xs, y_raw = _seq2seq_arrays(cfg, dev)
    ids, n_cls = _class_ids(y_raw, dev)
    cross_lats = [_seq2seq_pca(X, None, S2S_MAX_K) for X in Xs[1:]]
    # phoneme digits 1..9 -> classes 0..8 (train_seq2seq.py:95-96); the
    # start token is the model's num_classes
    y_seqs = [torch.as_tensor(np.asarray(y, np.int64) - 1, device=dev)
              for y in y_raw]
    return _Seq2SeqPrep(Xs[0], cross_lats, ids, n_cls,
                        ids[0].cpu().numpy(), y_seqs)


def run_train_seq2seq(cfg: TrainSeq2SeqConfig, verbose: bool = True,
                      device=None, *, prewarm_only: bool = False):
    """Seq2seq training, aligned pooling and k-fold CV (``cpsd
    train-seq2seq``); returns every fold's test accuracy, iteration after
    iteration, as numpy, also written to ``out`` as a CSV.

    Each of ``n_iter`` iterations splits the target into ``n_folds``
    stratified folds (numpy, as the JAX driver), refits the target PCA
    and the sources' CCA on each fold's train rows, pools, trains a
    Seq2SeqRNN per fold with teacher forcing and tests it. With
    ``fold_parallel`` (the default) the folds go through
    ``train.fold_parallel`` in chunks of ``fold_chunk``, each fold one
    full-batch step an epoch and one test after the last; otherwise each
    fold is one ``train.loops.fit`` that keeps its best test accuracy,
    checked every ``epochs // 20`` epochs. Per-iteration accuracies go to
    ``<out stem>.progress.pkl``, from which a rerun resumes.

    Runs on ``device`` (default: the first CUDA card; raises without one
    unless ``device='cpu'``). ``prewarm_only`` builds the kernel libraries
    and runs one epoch of one fold chunk (one fold sequentially), which
    pays the card's library set-up, and writes nothing.

    ``n_devices > 0`` (with ``fold_parallel``) shards every fold chunk
    over that many ranks: each rank prepares the same features, trains its
    block of the chunk's folds from the same per-fold seeds, and the
    accuracies are gathered, so the result equals the one-device run's.
    The world size must divide ``fold_chunk`` (or ``n_folds``), as in
    JAX. Called outside a process group, the driver launches the ranks
    itself and returns rank 0's accuracies; only rank 0 writes files.
    """
    if cfg.n_devices > 0:
        _check_seq2seq_mesh(cfg, device)
    if needs_launch(cfg.n_devices):
        return launch_driver(run_train_seq2seq, cfg.n_devices, device, cfg,
                             verbose, prewarm_only=prewarm_only)
    mesh, dev = mesh_and_device(cfg.n_devices, device)
    writes = is_writer(mesh)
    verbose = verbose and writes
    if prewarm_only:
        _build_libraries(dev)
        cfg = dataclasses.replace(cfg, n_iter=1, epochs=1, out="",
                                  log_metrics=False, trace=False)

    progress = (str(Path(cfg.out).with_suffix(".progress.pkl")) if cfg.out
                else "")
    done = from_rank0(lambda: _completed_results(
        progress, vars(cfg), scalar=False), mesh)[: cfg.n_iter]
    if done and verbose:
        print(f"resuming: {len(done)}/{cfg.n_iter} iterations done",
              flush=True)
    results = [float(a) for accs in done for a in np.ravel(accs)]
    if len(done) < cfg.n_iter:
        if progress and writes:
            Path(progress).parent.mkdir(parents=True, exist_ok=True)
        if cfg.fold_parallel:
            results += _seq2seq_fold_parallel(
                cfg, dev, len(done), progress if writes else "", verbose,
                prewarm_only, mesh)
        else:
            results += _seq2seq_sequential(cfg, dev, len(done), progress,
                                           verbose, prewarm_only)
    if prewarm_only:
        return np.asarray([])
    out = np.asarray(results)
    if cfg.out and writes:
        Path(cfg.out).parent.mkdir(parents=True, exist_ok=True)
        np.savetxt(cfg.out, out, delimiter=",")
    return out


def _check_seq2seq_mesh(cfg: TrainSeq2SeqConfig, device) -> None:
    """JAX's checks of ``n_devices`` for ``run_train_seq2seq``, before any
    rank starts: fold-parallel training only, no more ranks than cards
    (``parallel.mesh.rank_devices``), a world size that divides the fold
    chunk, and no ``rnn_impl='pallas'``."""
    from cross_patient_speech_decoding_tpu_torch.parallel.mesh import (
        rank_devices,
    )

    if not cfg.fold_parallel:
        raise ValueError(
            "n_devices requires fold_parallel=true: fold-axis sharding "
            "is the seq2seq driver's multi-chip strategy (the sequential "
            "path trains one fold at a time on one device)")
    if needs_launch(cfg.n_devices):
        rank_devices(cfg.n_devices, device)
    eff = cfg.fold_chunk if cfg.fold_chunk > 0 else cfg.n_folds
    if eff % cfg.n_devices:
        raise ValueError(
            f"mesh width {cfg.n_devices} must divide the per-program fold "
            f"count ({eff}: fold_chunk or n_folds) for fold-axis sharding")
    if cfg.rnn_impl == "pallas":
        raise ValueError(
            "rnn_impl='pallas' cannot be combined with a mesh: the "
            "sharded fold axis is the Pallas kernel's grid dimension")


def _seq2seq_run_name(cfg: TrainSeq2SeqConfig) -> str:
    return (f"{cfg.target_pt}_{'aligned' if cfg.pooled else 'ptSpecific'}"
            "_seq2seq")


def _seq2seq_iter_rng(cfg: TrainSeq2SeqConfig, it: int):
    return np.random.default_rng(cfg.seed + 7919 * it)


def _seq2seq_fold_parallel(cfg, dev, start_it, progress, verbose,
                           prewarm_only, mesh=None):
    """The fold-parallel iterations from ``start_it``: every fold of an
    iteration through the fold trainer (in chunks of ``fold_chunk``, the
    chunk at fold c0 seeded ``seed + it + 31 c0``, its folds sharded over
    ``mesh``); one row of per-fold accuracies an iteration in
    ``logs/<run>/fold_accs.csv``, written by rank 0."""
    from cross_patient_speech_decoding_tpu_torch.data.splits import (
        stratified_kfold_masks,
    )
    from cross_patient_speech_decoding_tpu_torch.train import fold_parallel
    from cross_patient_speech_decoding_tpu_torch.train.loops import (
        append_metrics,
    )

    prep = _seq2seq_prep(cfg, dev)
    trainer_fn = fold_parallel.make_seq2seq_fold_trainer_fn(
        _seq2seq_model(cfg), lr=cfg.lr, weight_decay=cfg.weight_decay,
        decay_iters=cfg.decay_iters, clip=cfg.clip, mesh=mesh,
        rnn_impl=cfg.rnn_impl)
    aug_names = _parse_augmentations(cfg.augmentations)
    run_name = _seq2seq_run_name(cfg)
    fold_log = (Path(cfg.out).parent / "logs" / run_name / "fold_accs.csv"
                if cfg.log_metrics and cfg.out and is_writer(mesh) else None)
    if fold_log is not None and start_it == 0 and fold_log.exists():
        # a fresh run: a log already there is an earlier run's
        fold_log.unlink()
    results = []
    for it in range(start_it, cfg.n_iter):
        tr_m, te_m = stratified_kfold_masks(prep.strat, cfg.n_folds,
                                            _seq2seq_iter_rng(cfg, it))
        feats = _seq2seq_fold_features(
            prep.tarX, prep.cross_lats, prep.ids, prep.n_classes,
            torch.as_tensor(tr_m, dtype=torch.float32, device=dev))
        tar_f, cross_f = feats[0], feats[1:]
        tar_y, cross_y = prep.y_seqs[0], prep.y_seqs[1:]
        te_pass = None
        if aug_names:
            # augmented copies of the aligned rows (datamodules.py:491-494)
            reps = len(aug_names) + 1
            gen = torch.Generator(device=dev).manual_seed(
                cfg.seed + 900 + it)
            if tar_f.dim() == 3:  # raw channels, shared: one copy a fold
                tar_f = tar_f.expand((len(tr_m),) + tar_f.shape)
            tar_f = _augment_stack_folds(tar_f, aug_names, gen)
            cross_f = [_augment_stack_folds(f, aug_names, gen)
                       for f in cross_f]
            tar_y = torch.cat([tar_y] * reps)
            cross_y = [torch.cat([y] * reps) for y in cross_y]
            tr_m, te_pass = _augmented_fold_masks(tr_m, te_m, reps)
        X_pool, y_pool, w, te = fold_parallel.pooled_fold_arrays(
            tar_f, tar_y, cross_f, cross_y, tr_m, test_masks=te_pass)
        del feats, tar_f, cross_f
        n_folds = w.shape[0]
        chunk = cfg.fold_chunk if cfg.fold_chunk > 0 else n_folds
        per_fold_x = X_pool.dim() == 4

        def chunk_args(c0):
            sl = slice(c0, c0 + chunk)
            return (X_pool[sl] if per_fold_x else X_pool), y_pool, w[sl], \
                te[sl]

        if prewarm_only:
            trainer_fn(*chunk_args(0), cfg.seed + it, cfg.epochs)
            return []
        with _maybe_trace(cfg.trace and it == start_it and is_writer(mesh),
                          cfg.out, run_name):
            parts = [trainer_fn(*chunk_args(c0), cfg.seed + it + 31 * c0,
                                cfg.epochs)[0]
                     for c0 in range(0, n_folds, chunk)]
        accs = torch.cat(parts).cpu().numpy()
        del X_pool, parts
        results.extend(accs.tolist())
        if progress:
            append_results_pkl(progress, accs, params=vars(cfg))
        if fold_log is not None:
            append_metrics(str(fold_log), {
                "iter": it,
                **{f"fold{j}": float(a) for j, a in enumerate(accs)}})
        if verbose:
            print(f"iter {it}: {cfg.n_folds} folds, mean test acc "
                  f"{accs.mean():.3f}", flush=True)
    return results


def _seq2seq_sequential(cfg, dev, start_it, progress, verbose,
                        prewarm_only):
    """The sequential iterations from ``start_it``: one ``fit`` per fold on
    the target's train rows and every aligned cross row, its test rows
    evaluated every ``max(1, epochs // 20)`` epochs and its best test
    accuracy kept (fold k's weights from ``seed + k``, its draws from
    ``seed + 100 + k``, its augmentations from ``seed + 900 + 100 it +
    k``); per-epoch logs under ``logs/<run>/``."""
    from cross_patient_speech_decoding_tpu_torch.data.splits import (
        stratified_kfold_masks,
    )
    from cross_patient_speech_decoding_tpu_torch.train import (
        create_train_state,
        make_seq2seq_eval_step,
        make_seq2seq_train_step,
    )
    from cross_patient_speech_decoding_tpu_torch.train.loops import (
        fit as fit_loop,
        make_optimizer,
    )

    prep = _seq2seq_prep(cfg, dev)
    model = _seq2seq_model(cfg)
    tx = make_optimizer(cfg.lr, cfg.weight_decay, cfg.decay_iters,
                        end_factor=0.01, clip=cfg.clip)
    aug_names = _parse_augmentations(cfg.augmentations)
    run_name = _seq2seq_run_name(cfg)
    y_t, y_cross = prep.y_seqs[0], prep.y_seqs[1:]
    results = []
    for it in range(start_it, cfg.n_iter):
        tr_m, te_m = stratified_kfold_masks(prep.strat, cfg.n_folds,
                                            _seq2seq_iter_rng(cfg, it))
        iter_accs = []
        for k in range(cfg.n_folds):
            tr_i = torch.as_tensor(np.where(tr_m[k] > 0)[0], device=dev)
            te_i = torch.as_tensor(np.where(te_m[k] > 0)[0], device=dev)
            feats = _seq2seq_fold_features(
                prep.tarX, prep.cross_lats, prep.ids, prep.n_classes,
                torch.as_tensor(tr_m[k], dtype=torch.float32, device=dev))
            X_train = torch.cat([feats[0][tr_i]] + feats[1:])
            y_train = torch.cat([y_t[tr_i]] + y_cross)
            if aug_names:
                gen = torch.Generator(device=dev).manual_seed(
                    cfg.seed + 900 + it * 100 + k)
                X_train = _augment_stack(X_train, aug_names, gen)
                y_train = torch.cat([y_train] * (len(aug_names) + 1))
            m = model(X_train.shape[-1], seed=cfg.seed + k, device=dev)
            state = create_train_state(m, tx)
            gen = torch.Generator(device=dev).manual_seed(cfg.seed + 100 + k)
            with _maybe_trace(cfg.trace and it == start_it and k == 0,
                              cfg.out, run_name):
                res = fit_loop(
                    state, make_seq2seq_train_step(m, tx),
                    make_seq2seq_eval_step(m), (X_train, y_train),
                    (feats[0][te_i], y_t[te_i]), epochs=cfg.epochs,
                    generator=gen, monitor="acc", mode="max",
                    batch_size=cfg.batch_size or None,
                    eval_every=max(1, cfg.epochs // 20),
                    log_path=(_run_log_path(cfg.out, run_name, it, k,
                                            fmt=cfg.log_format)
                              if cfg.log_metrics else None),
                    log_format=cfg.log_format)
            if prewarm_only:
                return []
            iter_accs.append(res.best_metric)
            if verbose:
                print(f"iter {it} fold {k}: best test acc "
                      f"{res.best_metric:.3f}", flush=True)
            del res, state, m, feats, X_train
        results.extend(iter_accs)
        if progress:
            append_results_pkl(progress, np.asarray(iter_accs),
                               params=vars(cfg))
    return results


# ---------------------------------------------------------------- train nn --

NN_MODELS = ("tcn", "transformer", "cnn_transformer", "conv_rnn")


def _make_nn_classifier(cfg: TrainNNConfig, in_features: int,
                        n_classes: int, seed: int = 0, device=None):
    """The run's classifier (the model zoo switch; the classifier the
    reference's aligned_decode_nn.py comments out and then uses), for
    (B, T, in_features) inputs, its weights drawn from ``seed`` on the
    host and moved to ``device``. The CNN-transformer's encoder keeps its
    own dropout default (0.1), as in the JAX package."""
    from cross_patient_speech_decoding_tpu_torch import models

    common = dict(num_classes=n_classes, seed=seed, device=device)
    if cfg.model == "tcn":
        return models.TCNClassifier(
            in_features, cfg.n_filters, kernel_size=cfg.kernel_size,
            dropout=cfg.dropout, **common)
    if cfg.model == "transformer":
        return models.TransformerClassifier(
            in_features, cfg.d_model, n_heads=cfg.n_heads,
            n_layers=cfg.n_layers, dim_ff=cfg.dim_ff, dropout=cfg.dropout,
            **common)
    if cfg.model == "cnn_transformer":
        return models.CNNTransformer(
            in_features, cfg.n_filters, kernel_size=cfg.kernel_size,
            n_heads=cfg.n_heads, n_layers=cfg.n_layers, dim_ff=cfg.dim_ff,
            cnn_dropout=cfg.dropout, **common)
    if cfg.model == "conv_rnn":
        return models.TemporalConvRNN(
            in_features, cfg.n_filters, cfg.hidden,
            kernel_size=cfg.kernel_size, n_layers=cfg.n_layers,
            cnn_dropout=cfg.dropout, rnn_dropout=cfg.dropout, **common)
    raise ValueError(f"unknown model {cfg.model!r}; choose "
                     + " | ".join(NN_MODELS))


def _nn_pca(X, mask, n_comp, max_k: int):
    """A patient's PCA latents (N, T, max_k), fitted on the trials of the
    (N,) ``mask`` (all trials when None), each component's sign fixed by
    ``decoders.pooled._pca_latents``' rule."""
    from cross_patient_speech_decoding_tpu_torch.decoders.pooled import (
        _pca_latents,
    )

    return _pca_latents(X, n_comp, max_k, mask)[1]


def _nn_fold_features(cfg: TrainNNConfig, tar, cross, cross_lats,
                      n_align: int, train_mask):
    """[target latents, each source's latents mapped into them] of one
    fold, each (N, T, K): the target's PCA and every CCA fit refitted on
    the fold's train rows only (the reference fits them on each fold's
    training data, datamodules.py:63-65, :471), so no test-fold label
    shapes the pooled features."""
    lat_t = _nn_pca(tar.X, train_mask, cfg.n_comp, cfg.max_k)
    return [lat_t] + [
        _cca_align_lat(lat_t, lat, tar.y_align, c.y_align, train_mask,
                       n_align)
        for c, lat in zip(cross, cross_lats)]


def run_train_nn(cfg: TrainNNConfig, verbose: bool = True, device=None):
    """NN-classifier cross-patient decode (``cpsd train-nn``); returns the
    test accuracy of every fold, (n_iter, n_folds) as numpy.

    Per-patient PCA latents, CCA alignment of each source into the
    target's space, pooled training of the ``cfg.model`` classifier,
    stratified k-fold CV on the target (numpy splits, as the JAX driver)
    and confusion-matrix accuracy per fold. The pooled train set is the
    target's train rows followed by every source's trials (the target
    alone with ``pooled=False``). A fold trains ``epochs`` epochs of
    mini-batches of ``batch_size`` and is tested once, after the last
    epoch, so the test split selects no checkpoint. Each iteration's fold
    accuracies are appended to the results pickle ``out``, from which a
    rerun resumes; per-fold logs go to ``logs/<run>/``.

    Runs on ``device`` (default: the first CUDA card; raises without one
    unless ``device='cpu'``). ``n_devices > 0`` trains every fold
    data-parallel on that many ranks
    (``parallel.make_sharded_classifier_train_step``: each rank's block of
    every mini-batch, gradients summed, BatchNorm statistics per shard).
    Called outside a process group, the driver launches the ranks itself
    and returns rank 0's accuracies; only rank 0 writes files.
    """
    from cross_patient_speech_decoding_tpu_torch.data.splits import (
        stratified_kfold_masks,
    )
    from cross_patient_speech_decoding_tpu_torch.parallel import (
        make_sharded_classifier_train_step,
    )
    from cross_patient_speech_decoding_tpu_torch.train import (
        create_train_state,
        make_classifier_eval_step,
        make_classifier_train_step,
    )
    from cross_patient_speech_decoding_tpu_torch.train.loops import (
        fit as fit_loop,
        make_optimizer,
    )

    if needs_launch(cfg.n_devices):
        return launch_driver(run_train_nn, cfg.n_devices, device, cfg,
                             verbose)
    mesh, dev = mesh_and_device(cfg.n_devices, device)
    writes = is_writer(mesh)
    verbose = verbose and writes
    tar, cross, n_y, n_a = patients_from_config(
        cfg.data, cfg.target_pt, cfg.p_ind, cfg.lab_type, cfg.algn_type,
        cfg.seed, device=dev)
    if not cfg.pooled:
        cross = ()
    # a source's trials are all training data: its latents are fitted once
    cross_lats = [_nn_pca(c.X, None, cfg.n_comp, cfg.max_k) for c in cross]
    labels = [tar.y] + [c.y for c in cross]
    tx = make_optimizer(cfg.lr, cfg.weight_decay, cfg.decay_iters,
                        end_factor=0.01, clip=cfg.clip)
    y_host = tar.y.cpu().numpy()

    if cfg.out and writes:
        Path(cfg.out).parent.mkdir(parents=True, exist_ok=True)
    all_accs = from_rank0(lambda: _completed_results(
        cfg.out, vars(cfg), scalar=False), mesh)[: cfg.n_iter]
    if all_accs and verbose:
        print(f"resuming: {len(all_accs)}/{cfg.n_iter} iterations done",
              flush=True)

    def train_step(model):
        if mesh is None:
            return make_classifier_train_step(model, tx)
        return make_sharded_classifier_train_step(model, tx, mesh)

    run_name = f"{cfg.target_pt}_{cfg.model}_nnDecode"
    start_it = len(all_accs)
    for it in range(start_it, cfg.n_iter):
        rng = np.random.default_rng(cfg.seed + 7919 * it)
        tr_m, te_m = stratified_kfold_masks(y_host, cfg.n_folds, rng)
        fold_accs = []
        for k in range(cfg.n_folds):
            tr_i = torch.as_tensor(np.where(tr_m[k] > 0)[0], device=dev)
            te_i = torch.as_tensor(np.where(te_m[k] > 0)[0], device=dev)
            feats = _nn_fold_features(
                cfg, tar, cross, cross_lats, n_a,
                torch.as_tensor(tr_m[k], dtype=torch.float32, device=dev))
            X_train = torch.cat([feats[0][tr_i]] + feats[1:])
            y_train = torch.cat([labels[0][tr_i]] + labels[1:])
            test = (feats[0][te_i], labels[0][te_i])
            model = _make_nn_classifier(cfg, X_train.shape[-1], n_y,
                                        seed=cfg.seed + 31 * it + k,
                                        device=dev)
            gen = torch.Generator(device=dev).manual_seed(
                cfg.seed + 1000 + 31 * it + k)
            with _maybe_trace(cfg.trace and it == start_it and k == 0
                              and writes, cfg.out, run_name):
                res = fit_loop(
                    create_train_state(model, tx), train_step(model),
                    make_classifier_eval_step(model), (X_train, y_train),
                    test, epochs=cfg.epochs, generator=gen, monitor="acc",
                    mode="max", batch_size=cfg.batch_size,
                    # final-epoch test only: the test split must not
                    # select the checkpoint
                    eval_every=cfg.epochs,
                    log_path=(_run_log_path(cfg.out, run_name, it, k,
                                            fmt=cfg.log_format)
                              if cfg.log_metrics and writes else None),
                    log_format=cfg.log_format)
            fold_accs.append(res.history[-1]["acc"])
        fold_accs = np.asarray(fold_accs)
        all_accs.append(fold_accs)
        if cfg.out and writes:
            append_results_pkl(cfg.out, fold_accs, params=vars(cfg))
        if verbose:
            print(f"iter {it} [{cfg.model}]: mean test acc "
                  f"{fold_accs.mean():.3f} (chance {1.0 / n_y:.3f})",
                  flush=True)
    return np.stack(all_accs)


# ----------------------------------------------------------------- prewarm --

def run_prewarm_ctc(cfg: TrainCTCConfig, verbose: bool = True, device=None):
    """Ready a CTC run ahead of time (``cpsd prewarm-ctc``): build the
    kernel and native beam libraries, then train one epoch of one
    iteration at the config's shapes, which pays the card's library
    set-up (cuBLAS, cuDNN, cuSOLVER). The JAX package filled its compile
    cache here; the port has none. Writes no results; returns an empty
    array."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    _build_libraries(dev, beam=True)
    run_train_ctc(dataclasses.replace(cfg, n_iter=1, epochs=1, out="",
                                      log_metrics=False, trace=False,
                                      results_h5=""),
                  verbose=False, device=device)
    if verbose:
        print(f"ctc libraries built and one epoch run in "
              f"{time.perf_counter() - t0:.1f}s (context={cfg.context})",
              flush=True)
    return np.asarray([])


def run_prewarm_seq2seq(cfg: TrainSeq2SeqConfig, verbose: bool = True,
                        device=None):
    """Ready a seq2seq run ahead of time (``cpsd prewarm-seq2seq``):
    ``run_train_seq2seq(..., prewarm_only=True)``, the kernel libraries
    built and one epoch of one fold chunk run. Writes no results; returns
    an empty array."""
    t0 = time.perf_counter()
    run_train_seq2seq(cfg, verbose=False, device=device, prewarm_only=True)
    if verbose:
        print(f"seq2seq libraries built and one epoch run in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
    return np.asarray([])


# ---------------------------------------------------------------- tune ctc --

def _tune_prep_cfg(cfg: TuneCTCConfig) -> TrainCTCConfig:
    """The TrainCTCConfig of a tune config's data prep (shared by the
    holdout and CV paths)."""
    context = "aligned" if cfg.align_train else (
        "unaligned" if cfg.pool_train else "patient"
    )
    return TrainCTCConfig(
        data=cfg.data, target_pt=cfg.target_pt, train_pts=cfg.train_pts,
        only_train_pts=cfg.only_train_pts, zscore=cfg.zscore,
        tw_orig=cfg.tw_orig, tw_select=cfg.tw_select, n_sil=cfg.n_sil,
        pca_path=cfg.pca_path, cca_path=cfg.cca_path,
        align_pt=cfg.align_pt, context=context, seed=cfg.seed,
        n_components=cfg.n_components,
        synth_patients=cfg.synth_patients,
        synth_trials=cfg.synth_trials, synth_T=cfg.synth_T,
    )


def _label_seq_class_ids(y) -> np.ndarray:
    """Integer class per label sequence row, the stratification key (the
    reference's select_cv stratifies on the sequence string)."""
    enc = encode_label_sequences(np.asarray(y))
    return to_class_ids(enc, np.unique(enc))[0]


def _tune_cv_trainer(cfg: TuneCTCConfig, rng: np.random.Generator, F: int,
                     device=None, mesh=None):
    """The reference's CV trainable (train_func_cv, tune_ctc_rnn.py:550-634):
    per-trial k-fold CV with the fold-mean validation PER.

    Fold membership is stratified over the target's label sequences; the
    cross patients' rows train in every fold
    (CTCHeldOutTargetValCVDataModule). Synthetic pooled contexts fit PCA
    and CCA per fold on that fold's target train rows (the leak-free
    AlignCV semantics), giving a per-fold feature stack; file data uses
    fold-invariant transforms.
    """
    from cross_patient_speech_decoding_tpu_torch.data.splits import (
        stratified_kfold_masks,
    )
    from cross_patient_speech_decoding_tpu_torch.sweep.ctc import (
        make_ctc_cv_bucket_trainer,
    )

    dev = resolve_device(device)
    pooled = cfg.align_train or cfg.pool_train
    if pooled or cfg.data != "synthetic":
        prep_cfg = _tune_prep_cfg(cfg)
        if cfg.data == "synthetic":
            cls = _label_seq_class_ids(_synthetic_ctc_cfg(cfg, dev)[0][1])
            f_tr, f_va = stratified_kfold_masks(cls, F, rng)
            fold_sets = [
                _prep_ctc_context(prep_cfg, rng, tar_train_mask=f_tr[f],
                                  device=dev)[0]
                for f in range(F)
            ]
            # per-fold transforms -> per-fold pooled features (F, N, T, C)
            x = torch.stack([torch.cat([_on(d[0], dev) for d in ds])
                             for ds in fold_sets])
            ds0 = fold_sets[0]
        else:
            ds0, _, _ = _prep_ctc_context(prep_cfg, rng, device=dev)
            cls = _label_seq_class_ids(ds0[0][1])
            f_tr, f_va = stratified_kfold_masks(cls, F, rng)
            x = torch.cat([_on(d[0], dev) for d in ds0])
        y = np.concatenate([np.asarray(d[1]) for d in ds0])
        il = np.concatenate([np.asarray(d[2]) for d in ds0])
        ll = np.concatenate([np.asarray(d[3]) for d in ds0])
        n_cross = len(y) - len(cls)
        w_tr = np.concatenate([f_tr, np.ones((F, n_cross))], axis=1)
        w_va = np.concatenate([f_va, np.zeros((F, n_cross))], axis=1)
    else:
        X, y, il, ll = _synthetic_ctc_cfg(cfg, dev)[0]
        cls = _label_seq_class_ids(y)
        w_tr, w_va = stratified_kfold_masks(cls, F, rng)
        x = _on(X, dev)
    return make_ctc_cv_bucket_trainer(
        (x, y, il, ll), w_tr, w_va, n_classes=11, seed=cfg.seed,
        mesh=mesh, model_chunk=cfg.model_chunk,
    )


def _tune_mesh(cfg: TuneCTCConfig, device=None):
    """The trial mesh of ``n_devices`` (this rank's, inside the process
    group), None for one device."""
    if cfg.n_devices <= 0:
        return None
    from cross_patient_speech_decoding_tpu_torch.parallel import make_mesh

    return make_mesh(cfg.n_devices, device=device)


def _tune_holdout_trainer(cfg: TuneCTCConfig, rng: np.random.Generator,
                          dev, mesh=None):
    """The single held-out validation split: precomputed transforms
    (pca_path) or on-the-fly PCA and CCA pooling of file or synthetic data
    (tune_ctc_rnn[_align]), or the target alone."""
    from cross_patient_speech_decoding_tpu_torch.sweep.ctc import (
        make_ctc_bucket_trainer,
    )

    pooled = cfg.align_train or cfg.pool_train
    if pooled or cfg.data != "synthetic":
        prep_cfg = _tune_prep_cfg(cfg)
        if cfg.data == "synthetic":
            # split first, so the pooled PCA and CCA fits exclude the
            # validation rows (the prep draws nothing on this path)
            n_tar = _synthetic_ctc_n_trials(cfg)
            tr, va, _ = train_val_test_masks(n_tar, rng)
            datasets, _, _ = _prep_ctc_context(
                prep_cfg, rng, tar_train_mask=tr, device=dev)
        else:
            datasets, _, _ = _prep_ctc_context(prep_cfg, rng, device=dev)
            tr, va, _ = train_val_test_masks(len(datasets[0][0]), rng)
        X, y, il, ll = datasets[0]
        tr_i, va_i = np.where(tr > 0)[0], np.where(va > 0)[0]
        parts = [(_take(X, tr_i), y[tr_i], il[tr_i], ll[tr_i])]
        parts += [tuple(d) for d in datasets[1:]]
        train = tuple(torch.cat([_on(p[j], dev) for p in parts])
                      for j in range(4))
        val = tuple(_on(_take(a, va_i), dev) for a in (X, y, il, ll))
    else:
        X, y, il, ll = _synthetic_ctc_cfg(cfg, dev)[0]
        tr, va, _ = train_val_test_masks(len(X), rng)
        tr_i, va_i = np.where(tr > 0)[0], np.where(va > 0)[0]
        train = tuple(_on(_take(a, tr_i), dev) for a in (X, y, il, ll))
        val = tuple(_on(_take(a, va_i), dev) for a in (X, y, il, ll))
    return make_ctc_bucket_trainer(train, val, n_classes=11, seed=cfg.seed,
                                   mesh=mesh)


def run_tune_ctc(cfg: TuneCTCConfig, verbose: bool = True, device=None):
    """CTC hyperparameter sweep (``cpsd tune-ctc``, the reference's
    tune_ctc_rnn.py): random trials through successive halving
    (``sampler=random``) or BOHB brackets of TPE proposals
    (``sampler=tpe``), each bucket of same-architecture trials trained
    by ``sweep/ctc.py`` on the held-out split or with ``cv_folds``-fold
    CV. Finished trials are appended to ``cfg.manifest``, from which a
    rerun resumes (the data prep waits for the first bucket to train, so
    a finished sweep fits nothing); ``hparam_out`` receives the winner in
    the reference's tuned-hparams layout for ``train-ctc hparam_dir=``.

    Runs on ``device`` (default: the first CUDA card; raises without one
    unless ``device='cpu'``). Returns the search's records, best first.
    ``n_devices > 0`` shards each bucket's (trial x fold) models over that
    many ranks (``sweep/ctc.py``'s ``mesh=``); every rank runs the same
    search from the same seeds. Called outside a process group, the
    driver launches the ranks itself and returns rank 0's records; only
    rank 0 writes the manifest and ``hparam_out``.
    """
    from cross_patient_speech_decoding_tpu_torch.sweep import (
        Manifest,
        SweepSpace,
        default_ctc_space,
        run_bohb,
        run_sweep,
        sample_trials,
    )

    if needs_launch(cfg.n_devices):
        return launch_driver(run_tune_ctc, cfg.n_devices, device, cfg,
                             verbose)
    mesh = _tune_mesh(cfg, device)
    dev = mesh.device if mesh is not None else resolve_device(device)
    writes = is_writer(mesh)
    verbose = verbose and writes
    rng = np.random.default_rng(cfg.seed)
    built = []

    def trainer(cfgs, epochs):
        # the data prep runs at the first bucket (the samplers draw from
        # their own seeds, not from rng), so a finished sweep resumes
        # without fitting anything; the JAX package preps up front
        if not built:
            built.append(
                _tune_cv_trainer(cfg, rng, int(cfg.cv_folds), dev, mesh)
                if cfg.cv_folds > 0
                else _tune_holdout_trainer(cfg, rng, dev, mesh))
        return built[0](cfgs, epochs)

    if writes:
        Path(cfg.manifest).parent.mkdir(parents=True, exist_ok=True)
    # rank 0 reads and appends the manifest; the others take its records
    manifest = Manifest(cfg.manifest if writes else None)
    manifest.done = from_rank0(lambda: manifest.done, mesh)
    rungs = tuple(int(r) for r in cfg.rungs.split(","))
    if cfg.sampler == "tpe":
        # BOHB-style model-based acquisition (tune_ctc_rnn.py:224-232)
        results = run_bohb(
            default_ctc_space(), trainer, n_trials=cfg.n_trials,
            batch=min(6, cfg.n_trials), rungs=rungs, eta=cfg.eta,
            manifest=manifest, seed=cfg.seed,
        )
    else:
        trials = sample_trials(SweepSpace(), cfg.n_trials, seed=cfg.seed)
        results = run_sweep(
            trials, trainer, manifest=manifest, rungs=rungs, eta=cfg.eta,
        )
    if results and cfg.hparam_out and writes:
        # the tune -> train handoff, in the reference's tuned-hparams
        # layout (train_ctc_rnn.py:375-423)
        from cross_patient_speech_decoding_tpu_torch.data.loaders import (
            save_tuned_hparams,
        )

        best_cfg = results[0]["config"]
        context = _tune_prep_cfg(cfg).context
        path = save_tuned_hparams(
            cfg.hparam_out, cfg.target_pt, _CONTEXT_NAMES[context],
            {
                "learning_rate": float(best_cfg["lr"]),
                "l2_reg": float(best_cfg["weight_decay"]),
                "hidden_size": int(best_cfg["hidden"]),
                "n_layers": int(best_cfg["n_layers"]),
                "dropout": float(best_cfg["dropout"]),
            },
        )
        if verbose:
            print(f"tuned hparams -> {path}", flush=True)
    if verbose and results:
        best = results[0]
        print(f"best val PER {best['metric']:.1f}% config {best['config']}",
              flush=True)
    return results


# ------------------------------------------------------------- make xforms --

def _offline_pca_components(X: np.ndarray, n_components: float):
    """PCA of a (trials, T, C) array, demeaned over the flattened rows in
    float64 on the host (as ``apply_latent_xform`` demeans where it
    applies the transform).

    ``n_components``: a fraction in (0, 1) keeps the fewest components
    reaching that cumulative variance; a whole value > 1 is a count
    (``n_components=30`` parses to 30.0); 1.0 is rejected rather than
    meaning one component.

    Returns ``(components (k, C), latents (trials, T, k) float32)``.
    """
    Xr = X.reshape(-1, X.shape[-1]).astype(np.float64)
    Xr = Xr - Xr.mean(axis=0, keepdims=True)
    _, s, Vt = np.linalg.svd(Xr, full_matrices=False)
    if 0 < n_components < 1:
        ev = s**2
        frac = np.cumsum(ev) / max(ev.sum(), np.finfo(np.float64).tiny)
        k = int(np.searchsorted(frac, n_components) + 1)
    elif n_components > 1 and float(n_components).is_integer():
        k = min(int(n_components), len(s))
    else:
        raise ValueError(
            "n_components must be a variance fraction in (0, 1) or a "
            f"whole component count > 1, got {n_components!r}"
        )
    k = max(k, 1)
    W = np.ascontiguousarray(Vt[:k])
    lat = np.asarray((Xr @ W.T).reshape(X.shape[0], X.shape[1], -1),
                     np.float32)
    return W, lat


def _xform_sources(cfg: MakeXformsConfig, dev):
    """(patient names, their X as float32 numpy, their label arrays): the
    target first, then the sources."""
    from cross_patient_speech_decoding_tpu_torch.data.loaders import (
        load_ctc_h5,
    )

    if cfg.data == "synthetic":
        pts_data = _synthetic_ctc_cfg(cfg, dev)
        names = [cfg.target_pt] + [
            p.strip() for p in cfg.train_pts.split(",")
            if p.strip() and p.strip() != cfg.target_pt
        ]
        names += [f"SYN{i}" for i in range(len(names), len(pts_data))]
        names = names[: len(pts_data)]
        Xs = [d[0].cpu().numpy().astype(np.float32)
              for d in pts_data[: len(names)]]
        ys = [np.asarray(d[1]) for d in pts_data[: len(names)]]
        return names, Xs, ys
    names = [cfg.target_pt]
    for pt in cfg.train_pts.split(","):
        pt = pt.strip()
        if pt and pt != cfg.target_pt:
            names.append(pt)
    if len(names) < 2:
        raise ValueError(
            "make-xforms needs train_pts: at least one source patient "
            "besides the target"
        )
    only_train_set = set(filter(None, cfg.only_train_pts.split(",")))
    tw_sel, tw_orig = _tuple_arg(cfg.tw_select), _tuple_arg(cfg.tw_orig)
    Xs, ys = [], []
    for pt in names:
        X_p, y_p, _, _ = load_ctc_h5(
            cfg.data, pt, tw_sel, tw_orig, zscore=cfg.zscore,
            only_train=pt in only_train_set,
        )
        Xs.append(np.asarray(X_p, np.float32))
        ys.append(np.asarray(y_p))
    return names, Xs, ys


def compute_xforms(cfg: MakeXformsConfig, device=None) -> dict:
    """What ``make-xforms`` writes, without writing it: each patient's PCA
    components (float64 numpy on the host) and each source's class-averaged
    ``gram`` CCA from its latents into the target's, fitted on ``device``
    (default: the first CUDA card).

    Returns ``{"names": [target, sources...], "pca": {pt: (k, C)},
    "cca": {(src, target): (k_src, k_target) float64}}``.
    """
    from cross_patient_speech_decoding_tpu_torch.ops.cca import (
        fit_cca_aligner,
    )

    dev = resolve_device(device)
    names, Xs, ys = _xform_sources(cfg, dev)
    comps, lats = {}, []
    for name, X in zip(names, Xs):
        W, lat = _offline_pca_components(X, cfg.n_components)
        comps[name] = W
        lats.append(lat)
    ids = [encode_label_sequences(y) for y in ys]
    lat_t = torch.as_tensor(lats[0], device=dev)
    cca = {}
    for name, lat, enc in zip(names[1:], lats[1:], ids[1:]):
        uni = np.unique(np.concatenate([ids[0], enc]))
        id_t = torch.as_tensor(to_class_ids(ids[0], uni)[0], device=dev)
        id_s = torch.as_tensor(to_class_ids(enc, uni)[0], device=dev)
        # the CCA takes unequal latent widths (proj_b_to_a is (k_src,
        # k_tgt)); the gram route in case a count above the rank kept
        # zero-variance latent columns
        al = fit_cca_aligner(lat_t, torch.as_tensor(lat, device=dev), id_t,
                             id_s, len(uni), method="gram")
        proj = al.alignment.proj_b_to_a.cpu().numpy()
        cca[(name, names[0])] = np.ascontiguousarray(proj, np.float64)
    return {"names": names, "pca": comps, "cca": cca}


def run_make_xforms(cfg: MakeXformsConfig, verbose: bool = True,
                    device=None):
    """Write the offline PCA/CCA transform h5s that ``tune-ctc`` and
    ``train-ctc`` read through ``pca_path=``/``cca_path=`` (``cpsd
    make-xforms``).

    File layout: ``{pt}/components`` (n_components, n_channels) and
    ``{src}_to_{tgt}/components`` (k_src, k_tgt) (tune_ctc_rnn.py:
    1050-1079). The reference only ever reads these files; this makes
    them from a CTC dataset's train blocks by :func:`compute_xforms` on
    ``device`` (default: the first CUDA card). Needs ``h5py``, and raises
    ``ImportError`` up front without it. Returns ``{"pca", "cca"}``.
    """
    try:
        import h5py  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "make-xforms writes h5 files and needs h5py, which is not "
            "installed") from e
    from cross_patient_speech_decoding_tpu_torch.data.loaders import (
        save_xforms_h5,
    )

    res = compute_xforms(cfg, device)
    comps, cca = res["pca"], res["cca"]
    Path(cfg.pca_out).parent.mkdir(parents=True, exist_ok=True)
    save_xforms_h5(cfg.pca_out, pca=comps)
    if verbose:
        widths = {n: comps[n].shape[0] for n in res["names"]}
        print(f"PCA components -> {cfg.pca_out} (widths {widths})",
              flush=True)
    Path(cfg.cca_out).parent.mkdir(parents=True, exist_ok=True)
    save_xforms_h5(cfg.cca_out, cca=cca)
    if verbose:
        print(
            f"CCA transforms -> {cfg.cca_out} "
            f"({', '.join(f'{s}->{t}' for s, t in cca)})",
            flush=True,
        )
    return {"pca": comps, "cca": cca}


# ------------------------------------------------------------ realtime sim --

def _sync(dev) -> None:
    """Wait for ``dev``'s queue (a CPU tensor's work is already done)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_realtime_sim(cfg: RealtimeSimConfig, verbose: bool = True,
                     device=None):
    """Streaming decode over a synthetic recording (``cpsd realtime-sim``):
    ms a bin over the whole stream and, with ``per_step_samples``, the
    per-step latency distribution.

    Runs on ``device`` (default: the first CUDA card; raises without one
    unless ``device='cpu'``). ``ckpt=`` streams a reference Lightning
    checkpoint (``models.torch_import``): its architecture and channel
    count replace the config's, in the config itself as in the JAX
    package. ``amortized_ms`` is the host loop of ``simulate_stream`` over
    the bins divided by their count (the JAX package fuses the bins in one
    scan). A per-step sample runs ``per_step_chain`` single steps, then one
    synchronisation, less the median cost of a synchronisation on an idle
    queue, over the chain. ``out=`` pickles the distribution with the
    config (``per_step_samples`` > 0 required).
    """
    import scipy.signal as sps

    from cross_patient_speech_decoding_tpu_torch.models import RealtimeRNN
    from cross_patient_speech_decoding_tpu_torch.realtime import (
        init_realtime_state,
        make_realtime_step,
        simulate_stream,
    )

    dev = resolve_device(device)
    rng = np.random.default_rng(cfg.seed)
    if cfg.ckpt:
        from cross_patient_speech_decoding_tpu_torch.models.torch_import \
            import realtime_rnn_from_ckpt

        model = realtime_rnn_from_ckpt(cfg.ckpt, device=dev)
        if model.bidirectional:
            raise ValueError(
                "streaming needs a unidirectional model (a bidirectional "
                "GRU cannot run causally)"
            )
        cfg.n_channels = model.in_channels
        cfg.hidden, cfg.n_layers = model.hidden, model.n_layers
        cfg.n_classes = model.n_classes
    else:
        model = RealtimeRNN(cfg.n_channels, cfg.hidden, cfg.n_layers,
                            cfg.n_classes, seed=cfg.seed, device=dev)
    model.eval()
    bs, as_ = [], []
    for lo, hi in ((0.35, 0.5), (0.5, 0.65), (0.65, 0.8)):
        b, a = sps.butter(2, [lo, hi], btype="band")
        bs.append(b)
        as_.append(a)
    b_np, a_np = np.stack(bs), np.stack(as_)
    bt = torch.as_tensor(b_np, dtype=torch.float32, device=dev)
    at = torch.as_tensor(a_np, dtype=torch.float32, device=dev)
    chunks = torch.as_tensor(
        rng.normal(size=(cfg.n_bins, cfg.n_channels, cfg.bin_len)),
        dtype=torch.float32, device=dev)

    def stream():
        state = init_realtime_state(model, b_np, a_np, cfg.n_channels)
        out = simulate_stream(model, state, chunks, bt, at)
        _sync(dev)
        return out

    stream()  # warm-up
    t0 = time.perf_counter()
    _, outs = stream()
    per_bin_ms = (time.perf_counter() - t0) / cfg.n_bins * 1e3
    if verbose:
        n_emit = int((outs[0] >= 0).sum())
        print(
            f"streamed {cfg.n_bins} bins: {per_bin_ms:.3f} ms/bin amortized, "
            f"{n_emit} symbols emitted",
            flush=True,
        )
    result = {"amortized_ms": per_bin_ms, "p50_ms": None, "p99_ms": None}

    if cfg.per_step_samples > 0:
        step = make_realtime_step(model)
        st = init_realtime_state(model, b_np, a_np, cfg.n_channels)
        R = cfg.per_step_chain
        for r in range(R):  # warm-up
            st, _ = step(st, chunks[r % cfg.n_bins], bt, at)
        _sync(dev)

        # synchronisation cost on an idle queue
        sync = []
        for _ in range(5):
            t0 = time.perf_counter()
            _sync(dev)
            sync.append(time.perf_counter() - t0)
        sync_base = float(np.median(sync))

        samples = []
        for s in range(cfg.per_step_samples):
            t0 = time.perf_counter()
            for r in range(R):
                st, _ = step(st, chunks[(s + r) % cfg.n_bins], bt, at)
            _sync(dev)
            samples.append(
                max(time.perf_counter() - t0 - sync_base, 0.0) / R * 1e3
            )
        result["p50_ms"] = float(np.percentile(samples, 50))
        # an empirical p99 needs >= 100 samples; below that the tail is
        # reported as the max
        result["max_ms"] = float(np.max(samples))
        if cfg.per_step_samples >= 100:
            result["p99_ms"] = float(np.percentile(samples, 99))
            tail_label, tail_ms = "p99", result["p99_ms"]
        else:
            tail_label, tail_ms = "max", result["max_ms"]
        result["samples_ms"] = np.asarray(samples)
        if verbose:
            print(
                f"per-step latency over {cfg.per_step_samples} samples x "
                f"{R} steps: p50 {result['p50_ms']:.3f} ms, "
                f"{tail_label} {tail_ms:.3f} ms (sync baseline "
                f"{sync_base * 1e3:.3f} ms subtracted)",
                flush=True,
            )
    if cfg.out:
        # the distribution for the supp_fig_20/24 latency analyses, which
        # need the per-step samples
        if "samples_ms" not in result:
            raise ValueError(
                "out= persists the per-step latency distribution; set "
                "per_step_samples > 0 (>= 100 for a meaningful p99)"
            )
        from cross_patient_speech_decoding_tpu_torch.data.loaders import (
            save_pkl,
        )

        Path(cfg.out).parent.mkdir(parents=True, exist_ok=True)
        save_pkl({"params": vars(cfg), **result}, cfg.out)
    return result


# ----------------------------------------------------------------- analyze --

def run_analyze(cfg, verbose: bool = True):
    """Statistical comparison of saved results files, the reference's
    fig_4/fig_5 notebook flow over driver outputs (`figure_analyses/
    fig_4.ipynb` cells 16/18, `fig_5.ipynb` stats cells).

    Each input is an incremental results pickle (``append_results_pkl``)
    or a reference CTC results h5 (h5py imported only for those);
    per-iteration fold accuracies or PERs are reduced to per-iteration
    means, then: all pairwise paired tests (Wilcoxon or sign-flip
    permutation) with BH-FDR, plus one-way ANOVA + Tukey HSD when 3+
    groups are given. Returns a dict with the comparison rows and the
    ANOVA result. Host-only (numpy and ``scipy.special``): it takes no
    device.
    """
    from cross_patient_speech_decoding_tpu_torch.analysis import (
        anova_tukey_by_group,
        context_comparison_table,
        paired_permutation_test,
        wilcoxon_signed_rank,
    )

    if cfg.test not in ("wilcoxon", "permutation"):
        raise ValueError(
            f"test must be 'wilcoxon' or 'permutation', got '{cfg.test}'"
        )
    groups: dict[str, np.ndarray] = {}
    for spec in cfg.inputs.split(","):
        spec = spec.strip()
        if not spec:
            continue
        name, _, path = spec.partition("=")
        if not path:
            raise ValueError(f"input '{spec}' is not name=path")
        if name in groups:
            raise ValueError(f"duplicate input name '{name}'")
        if path.endswith((".h5", ".hdf5")):
            # a reference CTC results h5 (train_ctc_rnn.py:448-491)
            from cross_patient_speech_decoding_tpu_torch.data.loaders import (
                load_ctc_results_h5,
            )

            pers = load_ctc_results_h5(path)["phoneme_error_rate"]
            groups[name] = np.array(
                [float(np.ravel(p).mean()) for p in pers]
            )
            continue
        store = load_pkl(path)
        accs = store.get("accs", [])
        if not accs:
            raise ValueError(f"'{path}' has no per-iteration results")
        groups[name] = np.array([float(np.ravel(a).mean()) for a in accs])
    if len(groups) < 2:
        raise ValueError("need at least two name=path inputs to compare")
    lengths = {k: len(v) for k, v in groups.items()}
    n_common = min(lengths.values())
    if verbose and len(set(lengths.values())) > 1:
        print(f"note: unequal iteration counts {lengths}; paired tests use "
              f"the first {n_common} iterations of each", flush=True)
    groups = {k: v[:n_common] for k, v in groups.items()}

    test = (paired_permutation_test if cfg.test == "permutation"
            else wilcoxon_signed_rank)
    rows = context_comparison_table(groups, alpha=cfg.alpha, test=test)
    result = {"groups": groups, "pairwise": rows, "anova": None}
    if len(groups) >= 3:
        (anova_row,) = anova_tukey_by_group({"all": list(groups.values())})
        result["anova"] = anova_row
    if verbose:
        for name, vals in groups.items():
            print(f"{name:12s}: {vals.mean():.3f} +- {vals.std():.3f} "
                  f"(n={len(vals)})", flush=True)
        for r in rows:
            print(f"{cfg.test} {r.a} vs {r.b}: stat={r.statistic:.2f} "
                  f"p={r.pvalue:.4f} p_fdr={r.pvalue_fdr:.4f}"
                  f"{' *' if r.significant else ''}", flush=True)
        if result["anova"] is not None:
            a = result["anova"]
            print(f"ANOVA: F={a.f_statistic:.2f} p={a.anova_p:.2e}", flush=True)
    return result
