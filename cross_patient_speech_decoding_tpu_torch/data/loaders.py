"""File IO of the drivers: the reference's ``.mat`` feature files and
electrode geometry, result pickles, the reference's decoding-data pickle,
the CTC HDF5 layout, offline PCA/CCA transforms, tuned hyperparameters and
the results h5.

Port of ``cross_patient_speech_decoding_tpu/data/loaders.py`` (numpy, the
port's own copy): the same keys, layouts and bytes, so files written by
either package are read by the other. ``scipy.io`` and ``h5py`` are
imported inside the functions that need them, so the module imports where
they are not installed.

Everything returns numpy; device placement happens in the driver.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from cross_patient_speech_decoding_tpu_torch.utils.labels import phon_to_artic


# ---------------------------------------------------------------- .mat ----

def mat_filename(pt: str, phon_idx: int | None = None, sig_channel: bool = True,
                 zscore: bool = False) -> str:
    """Reference filename scheme (feature_data_from_mat.py:95-138):
    ``{pt}_HG[_p{n}]_{sigChannel|all}[_zscore]_goodTrials.mat``."""
    parts = [pt, "HG"]
    if phon_idx is not None:
        parts.append(f"p{phon_idx}")
    parts.append("sigChannel" if sig_channel else "all")
    if zscore:
        parts.append("zscore")
    parts.append("goodTrials")
    return "_".join(parts) + ".mat"


def load_high_gamma_mat(path: str | Path):
    """Load one .mat file -> dict with hgMap (tr, t, ch), labels (tr, L).

    Accepts the reference's key conventions: ``hgMap`` (trials, time,
    channels), optional ``hgTrace`` (trials, cx, cy, time), and
    ``phonSeqLabels`` (trials, seq_len).
    """
    from scipy.io import loadmat

    raw = loadmat(str(path))
    out = {}
    # pre-averaged spatial keys cs_{a}x{b} (feature_data_from_mat.py:165-185)
    cs_keys = [k for k in raw if k.startswith("cs_")]
    for k in cs_keys:
        out[k] = np.asarray(raw[k], np.float32)
    if "hgMap" in raw:
        out["X"] = np.asarray(raw["hgMap"], np.float32)
    elif "hgTrace" in raw:
        tr = np.asarray(raw["hgTrace"], np.float32)  # (tr, cx, cy, t)
        out["X"] = tr.reshape(tr.shape[0], -1, tr.shape[-1]).transpose(0, 2, 1)
    if "phonSeqLabels" in raw:
        out["y_seq"] = np.asarray(raw["phonSeqLabels"], np.int64)
    return out


def load_subject_phoneme_data(data_dir: str | Path, pt: str, n_phon: int = 3,
                              sig_channel: bool = True, zscore: bool = False):
    """Per-phoneme files -> subject dict X1..Xn, y1..yn, y_full_phon.

    Mirrors ``load_subject_high_gamma_phoneme`` (feature_data_from_mat.py:
    38-67): one .mat per phoneme position plus full sequence labels.
    """
    data_dir = Path(data_dir)
    subj = {}
    for p in range(1, n_phon + 1):
        d = load_high_gamma_mat(
            data_dir / mat_filename(pt, p, sig_channel, zscore)
        )
        subj[f"X{p}"] = d["X"]
        subj[f"y{p}"] = d["y_seq"][:, p - 1] if d["y_seq"].ndim > 1 else d["y_seq"]
        if p == 1:
            subj["y_full_phon"] = d["y_seq"]
    subj["X_collapsed"] = np.concatenate(
        [subj[f"X{p}"] for p in range(1, n_phon + 1)], axis=0
    )
    subj["y_phon_collapsed"] = np.concatenate(
        [subj[f"y{p}"] for p in range(1, n_phon + 1)], axis=0
    )
    return subj


def save_high_gamma_mat(path: str | Path, X: np.ndarray,
                        y_seq: np.ndarray,
                        hg_trace: np.ndarray | None = None,
                        cs: dict[str, np.ndarray] | None = None):
    """Write the reference .mat layout (inverse of
    :func:`load_high_gamma_mat`): ``hgMap`` (trials, time, channels),
    ``phonSeqLabels`` (trials, L), ``hgTrace`` (trials, cx, cy, time)
    when given (reference files carry both; ``get_high_gamma_data``
    reads both unconditionally, feature_data_from_mat.py:140-162), and
    pre-averaged ``cs_{a}x{b}`` arrays for the spatial-avg loader
    (:165-185)."""
    from scipy.io import savemat

    data: dict = {"hgMap": np.asarray(X), "phonSeqLabels": np.asarray(y_seq)}
    if hg_trace is not None:
        data["hgTrace"] = np.asarray(hg_trace)
    for k, v in (cs or {}).items():
        data[f"cs_{k}" if not k.startswith("cs_") else k] = np.asarray(v)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    savemat(str(path), data)


# -------------------------------------------------- electrode geometry ----

def load_channel_map(data_dir: str | Path, pt: str, trim: bool = True):
    """Load ``{data_dir}/{pt}/{pt}_channelMap.mat`` (key ``chanMap``).

    Returns ``(chan_map, transposed)``: the 2-D array of channel numbers
    (NaN for missing corners) and whether the 24-long axis was axis 0.
    The reference trims the full-NaN edge rows/cols of 24-wide maps and,
    when the 24-long axis is axis 0, also transposes the requested window
    size (``grid_subsampling.py:33-38``) — callers use ``transposed`` to
    apply that window flip.
    """
    from scipy.io import loadmat

    path = Path(data_dir) / pt / f"{pt}_channelMap.mat"
    m = np.asarray(loadmat(str(path))["chanMap"], np.float64)
    transposed = False
    if trim:
        if m.shape[0] == 24:
            m = m[1:-1, :]
            transposed = True
        elif m.shape[1] == 24:
            m = m[:, 1:-1]
    return m, transposed


def load_sig_channels(data_dir: str | Path, pt: str) -> np.ndarray:
    """Load ``{data_dir}/{pt}/{pt}_sigChannel.mat`` (key ``sigChannel``).

    1-D array of significant channel numbers — the channel axis of the
    ``*_sigChannel`` feature files is these channels in this order
    (``grid_subsampling.py:26-30`` load + ``feature_data_from_mat.py``
    filename scheme).
    """
    from scipy.io import loadmat

    path = Path(data_dir) / pt / f"{pt}_sigChannel.mat"
    return np.squeeze(
        np.asarray(loadmat(str(path))["sigChannel"])
    ).astype(np.int64)


def canonical_channel_map(pt: str) -> np.ndarray:
    """The paper patients' flat-index channel maps (1-based), as hardcoded
    by the figure notebooks' ``get_pt_map_from_flat`` (fig_2.ipynb and
    supp_fig_4/6_7): 128-contact arrays are 16x8 column-major grids
    (S23/S26 flipped up-down); 288-contact arrays are 12x24 / 24x12
    orientations per patient. Used when no ``{pt}_channelMap.mat`` is
    available (electrode-map visualization of full-grid data)."""
    if pt in ("S14", "S22"):
        return np.arange(128).reshape(8, 16).T + 1
    if pt in ("S23", "S26"):
        return np.flipud(np.arange(128).reshape(8, 16).T) + 1
    if pt == "S33":
        return np.fliplr(np.flipud(np.arange(288).reshape(12, 24))) + 1
    if pt == "S39":
        return np.arange(288).reshape(24, 12).T + 1
    return np.flipud(np.arange(288).reshape(24, 12).T) + 1


def save_geometry_mat(data_dir: str | Path, pt: str, chan_map: np.ndarray,
                      sig_channels: np.ndarray):
    """Write the geometry fixture files in the reference layout (inverse of
    :func:`load_channel_map`/:func:`load_sig_channels`; tests + examples)."""
    from scipy.io import savemat

    d = Path(data_dir) / pt
    d.mkdir(parents=True, exist_ok=True)
    savemat(str(d / f"{pt}_channelMap.mat"), {"chanMap": chan_map})
    savemat(str(d / f"{pt}_sigChannel.mat"),
            {"sigChannel": np.asarray(sig_channels)})


# ------------------------------------------------------------- pickles ----

def save_pkl(obj, path):
    with open(path, "wb") as f:
        pickle.dump(obj, f, protocol=-1)


def load_pkl(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def decoding_data_from_dict(data_dict: dict, pt: str, p_ind: int,
                            lab_type: str = "phon",
                            algn_type: str = "phon_seq"):
    """Unpack a ``pt_decoding_data*.pkl`` dict (the reference's
    alignment_utils.py:127-184 contract).

    Returns ((X_tar, y_tar, y_align_tar), [(X, y, y_align), ...]) for the
    target and its ``pre_pts``: ``p_ind=-1`` selects the arrays collapsed
    across phoneme positions and tiles the full sequence labels x3;
    ``lab_type='artic'`` maps phonemes to articulators.
    """

    def one(pt_key):
        d = data_dict[pt_key]
        lab_full = d["y_full_" + algn_type[: -len("_seq")]]
        if p_ind == -1:
            X = d["X_collapsed"]
            y = d["y_" + lab_type + "_collapsed"]
            lab_full = np.tile(lab_full, (3, 1))
        else:
            X = d[f"X{p_ind}"]
            y = d[f"y{p_ind}"]
        if lab_type == "artic":
            y = phon_to_artic(y)
        return X, y, lab_full

    tar = one(pt)
    pre = [one(p) for p in data_dict[pt]["pre_pts"]]
    return tar, pre


# ----------------------------------------------------------------- HDF5 ----

SIL_TOKEN = 10  # train_ctc_rnn.py:34 (PHON_DICT entry 10 = 'sil')


def load_ctc_h5(path: str | Path, pt: str, tw_select=(0.5, 3.5),
                tw_orig=(0.0, 4.0), zscore: bool = False,
                only_train: bool = False, load_all: bool = False,
                n_sil: int = 0, sil_token: int = SIL_TOKEN):
    """Load one patient's CTC train/test data from the reference HDF5 layout.

    Exact contract of ``train_ctc_rnn.load_data``
    (the reference's `scripts/train_ctc_rnn.py:264-320`):

    - train features at ``{pt}/norm_rt_HG_pow[_z]``, test features at
      ``{pt}/norm_rt_HG_test_pow[_z]``, both stored (trials, channels,
      time) and transposed to (trials, time, channels) on load;
    - labels at ``{pt}/labels_train`` / ``{pt}/labels_test``;
    - time-window crop via the *inclusive* linspace mask over
      ``tw_orig`` -> ``tw_select`` (not an index round);
    - ``n_sil`` silence tokens prepended AND appended to every label row;
    - ``only_train`` skips test arrays; ``load_all`` concatenates
      train+test into one training set (used for non-target patients).

    Returns ``(X_train, y_train, X_test, y_test)``; test entries are None
    under ``only_train``/``load_all`` (which are mutually exclusive:
    ``load_all`` needs the test block ``only_train`` skips).
    """
    import h5py

    if only_train and load_all:
        raise ValueError("only_train and load_all are mutually exclusive")

    key_train = "norm_rt_HG_pow_z" if zscore else "norm_rt_HG_pow"
    key_test = "norm_rt_HG_test_pow_z" if zscore else "norm_rt_HG_test_pow"
    with h5py.File(str(path), "r") as f:
        X_train = np.asarray(f[f"{pt}/{key_train}"], np.float32).transpose(0, 2, 1)
        y_train = np.asarray(f[f"{pt}/labels_train"], np.int64)
        if only_train:
            X_test = y_test = None
        else:
            X_test = np.asarray(f[f"{pt}/{key_test}"], np.float32).transpose(0, 2, 1)
            y_test = np.asarray(f[f"{pt}/labels_test"], np.int64)

    t_orig = np.linspace(tw_orig[0], tw_orig[1], X_train.shape[1])
    mask = (t_orig >= tw_select[0]) & (t_orig <= tw_select[1])
    X_train = X_train[:, mask, :]
    if not only_train:
        X_test = X_test[:, mask, :]

    for _ in range(n_sil):
        y_train = np.insert(y_train, 0, sil_token, axis=1)
        y_train = np.insert(y_train, y_train.shape[1], sil_token, axis=1)
        if not only_train:
            y_test = np.insert(y_test, 0, sil_token, axis=1)
            y_test = np.insert(y_test, y_test.shape[1], sil_token, axis=1)

    if load_all:
        X_train = np.concatenate([X_train, X_test], axis=0)
        y_train = np.concatenate([y_train, y_test], axis=0)
        X_test = y_test = None
    return X_train, y_train, X_test, y_test


def save_ctc_h5(path: str | Path, pt: str, X_train: np.ndarray,
                y_train: np.ndarray, X_test: np.ndarray | None = None,
                y_test: np.ndarray | None = None, zscore: bool = False):
    """Write the reference CTC HDF5 layout (inverse of :func:`load_ctc_h5`).

    Features are given (trials, time, channels) and stored
    (trials, channels, time) as the reference files are.
    """
    import h5py

    key_train = "norm_rt_HG_pow_z" if zscore else "norm_rt_HG_pow"
    key_test = "norm_rt_HG_test_pow_z" if zscore else "norm_rt_HG_test_pow"
    items = [(key_train, X_train.transpose(0, 2, 1)), ("labels_train", y_train)]
    if X_test is not None:
        items += [(key_test, X_test.transpose(0, 2, 1)), ("labels_test", y_test)]
    with h5py.File(str(path), "a") as f:
        g = f.require_group(pt)
        for k, v in items:
            if k in g:
                del g[k]
            g.create_dataset(k, data=v)


# ------------------------------------------- precomputed latent transforms ----

def load_pca_xform(pca_path: str | Path, pt: str) -> np.ndarray:
    """Per-patient offline PCA projection, transposed for X @ W use.

    Contract of ``tune_ctc_rnn.load_pca_xform``
    (the reference's `scripts/tune_ctc_rnn.py:1050-1063`):
    components stored (n_components, n_channels) at ``{pt}/components``.
    """
    import h5py

    with h5py.File(str(pca_path), "r") as f:
        return np.asarray(f[f"{pt}/components"]).T


def load_cca_xform(cca_path: str | Path, align_pt: str, source_pt: str) -> np.ndarray:
    """CCA map from ``source_pt`` latent space into ``align_pt`` space.

    Contract of ``tune_ctc_rnn.load_cca_xform`` (`tune_ctc_rnn.py:
    1066-1079`): matrix stored at ``{source_pt}_to_{align_pt}/components``.
    """
    import h5py

    with h5py.File(str(cca_path), "r") as f:
        return np.asarray(f[f"{source_pt}_to_{align_pt}/components"])


def save_xforms_h5(path: str | Path, pca: dict[str, np.ndarray] | None = None,
                   cca: dict[tuple[str, str], np.ndarray] | None = None):
    """Write offline PCA/CCA transforms in the reference layout, the one
    :func:`load_pca_xform` and :func:`load_cca_xform` read.

    ``pca[pt]`` is (n_components, n_channels), stored as is under
    ``{pt}/components``; ``cca[(src, tgt)]`` under
    ``{src}_to_{tgt}/components``. The file is opened for appending, and a
    dataset already there is replaced.
    """
    import h5py

    with h5py.File(str(path), "a") as f:
        groups = [(pt, comp) for pt, comp in (pca or {}).items()]
        groups += [(f"{src}_to_{tgt}", comp)
                   for (src, tgt), comp in (cca or {}).items()]
        for name, comp in groups:
            g = f.require_group(name)
            if "components" in g:
                del g["components"]
            g.create_dataset("components", data=np.asarray(comp))


def apply_latent_xform(X: np.ndarray, pca_xform: np.ndarray,
                       cca_xform: np.ndarray | None = None) -> np.ndarray:
    """Project (trials, time, channels) through offline PCA (+ optional CCA).

    Mirrors the tune-time application (`tune_ctc_rnn.py:122-148,169-185`):
    demean over flattened (trials*time) rows in realtime space (NOT the
    saved offline mean), then ``X @ pca_xform``, then optionally
    ``@ cca_xform`` into the alignment patient's space.
    """
    n_tr, n_t, n_ch = X.shape
    Xr = X.reshape(-1, n_ch).astype(np.float64)
    Xr = Xr - Xr.mean(axis=0, keepdims=True)
    Xr = Xr @ np.asarray(pca_xform, np.float64)
    if cca_xform is not None:
        Xr = Xr @ np.asarray(cca_xform, np.float64)
    return np.ascontiguousarray(Xr.reshape(n_tr, n_t, -1), dtype=np.float32)


# -------------------------------------------------------- tuned hparams ----

def load_tuned_hparams(hparam_dir: str | Path, target_pt: str, context: str,
                       defaults: dict) -> dict:
    """Overlay tuned hyperparameters from a previous sweep onto defaults.

    Contract of ``train_ctc_rnn.load_hparams`` (`train_ctc_rnn.py:375-423`):
    file ``{hparam_dir}/{pt}/{pt}_ctcRNN_{context}_hp.h5`` holds scalar
    datasets; any key present in ``defaults`` is replaced; a missing file
    falls back to the defaults (with a console note, as the reference does).
    Context names: 'aligned' | 'unaligned' | 'chance' | 'ptSpecific'.
    """
    import h5py

    out = dict(defaults)
    fname = Path(hparam_dir).expanduser() / target_pt / (
        f"{target_pt}_ctcRNN_{context}_hp.h5"
    )
    try:
        with h5py.File(str(fname), "r") as f:
            for k, v in f.items():
                if k in out:
                    val = v[()]
                    out[k] = val.item() if hasattr(val, "item") else val
    except (FileNotFoundError, OSError):
        print(
            "Saved hyperparameters not found! Using defaults from config.",
            flush=True,
        )
    return out


# --------------------------------------------------------------- results ----

def load_ctc_results_h5(path: str | Path) -> dict:
    """Read a reference CTC results h5 (`train_ctc_rnn.save_results`,
    train_ctc_rnn.py:448-491): per-iteration ``phoneme_error_rate``,
    ``logits``, the ``phon_keys``/``phon_vals`` token table, and the
    ``model_hparams`` attribute group, so existing reference result files
    feed the analysis flows (``cpsd analyze``) directly."""
    import h5py

    out: dict = {}
    with h5py.File(str(Path(path).expanduser()), "r") as f:
        out["phoneme_error_rate"] = np.asarray(f["phoneme_error_rate"])
        if "logits" in f:
            out["logits"] = np.asarray(f["logits"])
        if "phon_keys" in f and "phon_vals" in f:
            keys = np.asarray(f["phon_keys"]).tolist()
            vals = [
                v.decode() if isinstance(v, bytes) else str(v)
                for v in np.asarray(f["phon_vals"]).tolist()
            ]
            out["phon_dict"] = dict(zip(keys, vals))
        if "model_hparams" in f:
            out["model_hparams"] = dict(f["model_hparams"].attrs)
    return out


def save_ctc_results_h5(path: str | Path, pers, logits=None,
                        phon_dict: dict | None = None,
                        model_hparams: dict | None = None) -> Path:
    """Write CTC results in the reference's h5 layout (the inverse of
    :func:`load_ctc_results_h5`) so notebooks written against
    ``train_ctc_rnn``'s output keep working on this framework's runs."""
    import h5py

    path = Path(path).expanduser()
    path.parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(str(path), "w") as f:
        f.create_dataset("phoneme_error_rate", data=np.asarray(pers))
        if logits is not None:
            f.create_dataset("logits", data=np.asarray(logits))
        if phon_dict:
            f.create_dataset(
                "phon_keys", data=np.asarray(list(phon_dict.keys()), int)
            )
            f.create_dataset(
                "phon_vals",
                data=np.asarray(list(phon_dict.values()), dtype="S"),
            )
        grp = f.create_group("model_hparams")
        for k, v in (model_hparams or {}).items():
            grp.attrs[k] = v
    return path


def save_tuned_hparams(hparam_dir: str | Path, target_pt: str, context: str,
                       hparams: dict) -> Path:
    """Write a tuned-hparams h5 in the layout :func:`load_tuned_hparams`
    (and the reference's ``train_ctc_rnn.load_hparams``) reads,
    ``{hparam_dir}/{pt}/{pt}_ctcRNN_{context}_hp.h5`` with one scalar
    dataset per hyperparameter: the tune -> train handoff."""
    import h5py

    fname = Path(hparam_dir).expanduser() / target_pt / (
        f"{target_pt}_ctcRNN_{context}_hp.h5"
    )
    fname.parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(str(fname), "w") as f:
        for k, v in hparams.items():
            f.create_dataset(k, data=v)
    return fname


def append_results_pkl(path: str | Path, accs, params: dict | None = None,
                       extra: dict | None = None):
    """Incremental result persistence (data_saving.py:22-83 behavior):
    append per-iteration accuracies (+ params once) into a pickle."""
    path = Path(path)
    if path.exists():
        store = load_pkl(path)
    else:
        store = {"accs": [], "params": params or {}}
    store["accs"].append(np.asarray(accs))
    if extra:
        store.setdefault("extra", []).append(extra)
    save_pkl(store, path)
    return store
