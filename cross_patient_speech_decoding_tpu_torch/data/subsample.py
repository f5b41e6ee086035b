"""Electrode subsampling: sliding sub-grids, spatial averaging, Poisson-disk
pitch sampling, and trial-count subsampling.

Port of ``cross_patient_speech_decoding_tpu/data/subsample.py`` (numpy,
the port's own copy): host-side index generation that feeds the device
gathers of the subsample sweeps (``cli/subsample_experiments.py``). The
same ``np.random.Generator`` gives the same indices, bit for bit, as the
JAX package's functions, so a sweep draws the same sub-grids, pitch
samples and trial subsets in both. The reference's modules
(`aligned_decoding/processing_utils/`):
- ``grid_subsampling.py:8-98``: slide winSize x winSize sub-grids over a 2-D
  channel map (NaN edges), keep sub-grids containing >=1 significant
  channel, return per-grid significant-channel index lists;
- ``spatial_avg_subsampling.py:11-119``: non-overlapping contactSize^2
  tiles (centered), averaging channels per tile to simulate bigger contacts;
- ``poisson_disk_sampling.py:9-222``: Bridson dart-throwing at a physical
  pitch with re-sampling retries when no significant channel is drawn.
"""

from __future__ import annotations

import numpy as np


def grid_subsample_sig_channels(channel_map: np.ndarray, sig_channels,
                                win_size, step=(1, 1)):
    """All sliding sub-grids containing >=1 significant channel.

    Args:
        channel_map: 2-D array of channel ids with NaN for missing corners
            (pre-trimmed — see ``data.loaders.load_channel_map``).
        sig_channels: 1-D array of significant channel ids.
        win_size: sub-grid size — an int (square) or (rows, cols) tuple
            (the reference's "x-y" window string, grid_subsampling.py:8).
        step: sliding step per axis (grid_subsampling.py step kwarg).

    Returns:
        list of 1-D arrays: for each kept sub-grid, the indices INTO
        ``sig_channels`` of the significant channels inside it (the
        reference's contract — indices address the significant-channel
        feature axis).
    """
    sig = np.asarray(sig_channels)
    H, W = channel_map.shape
    wh, ww = (win_size, win_size) if np.isscalar(win_size) else win_size
    sh, sw = (step, step) if np.isscalar(step) else step
    grids = []
    for i in range(0, H - wh + 1, sh):
        for j in range(0, W - ww + 1, sw):
            block = channel_map[i : i + wh, j : j + ww].ravel()
            chans = block[~np.isnan(block)].astype(np.int64)
            idx = np.where(np.isin(sig, chans))[0]
            if idx.size:
                grids.append(idx)
    return grids


def spatial_avg_groups(channel_map: np.ndarray, contact_size: int):
    """Non-overlapping contact_size^2 tiles, centered on the grid.

    Returns list of 1-D channel-id arrays (one per tile with >=1 channel).
    """
    H, W = channel_map.shape
    off_i = (H % contact_size) // 2
    off_j = (W % contact_size) // 2
    groups = []
    for i in range(off_i, H - contact_size + 1, contact_size):
        for j in range(off_j, W - contact_size + 1, contact_size):
            block = channel_map[i : i + contact_size, j : j + contact_size]
            chans = block[~np.isnan(block)].astype(np.int64).ravel()
            if chans.size:
                groups.append(chans)
    return groups


def spatial_avg_data(data: np.ndarray, groups, channel_ids=None):
    """Average channel groups -> (trials, time, n_groups).

    Args:
        data: (trials, time, channels) array.
        groups: list of channel-id arrays from :func:`spatial_avg_groups`.
        channel_ids: ids corresponding to data's channel axis (default
            0..C-1).
    """
    C = data.shape[-1]
    ids = np.arange(C) if channel_ids is None else np.asarray(channel_ids)
    cols = []
    for g in groups:
        sel = np.where(np.isin(ids, g))[0]
        if sel.size:
            cols.append(data[..., sel].mean(axis=-1))
    return np.stack(cols, axis=-1)


def spatial_avg_matrix(groups, channel_ids=None, n_channels: int = None):
    """(n_channels, n_kept_groups) averaging matrix, the device-friendly
    form of :func:`spatial_avg_data`: ``X @ A`` over the channel axis
    equals the host tile-average, but the (tiny) matrix is built on the
    host while the trial tensor stays on the device."""
    ids = np.arange(n_channels) if channel_ids is None else np.asarray(
        channel_ids
    )
    cols = []
    for g in groups:
        sel = np.isin(ids, g).astype(np.float32)
        if sel.any():
            cols.append(sel / sel.sum())
    return np.stack(cols, axis=-1)


def array_distance(locs1: np.ndarray, locs2: np.ndarray,
                   kind: str = "mean") -> float:
    """Distance between two electrode arrays' physical locations
    (supp_fig_19's ``mean/min/max_arr_dist``): 'mean' = distance between
    array centroids; 'min'/'max' = extreme pairwise electrode distance."""
    a = np.asarray(locs1, np.float64)
    b = np.asarray(locs2, np.float64)
    if kind == "mean":
        return float(np.linalg.norm(a.mean(0) - b.mean(0)))
    d = np.linalg.norm(a[:, None, :] - b[None, :, :], axis=-1)
    if kind == "min":
        return float(d.min())
    if kind == "max":
        return float(d.max())
    raise ValueError(f"kind must be mean|min|max, got {kind!r}")


def poisson_disk_sample(positions: np.ndarray, radius: float,
                        rng: np.random.Generator, k: int = 30,
                        max_restarts: int = 20, n_points: int | None = None):
    """Bridson dart-throwing over a discrete electrode layout.

    Args:
        positions: (n, 2) physical electrode coordinates (mm).
        radius: minimum pairwise distance (pitch, mm).
        rng: numpy Generator.
        k: candidate darts per active point.
        max_restarts: restarts before accepting the best draw so far.
        n_points: stop once this many electrodes are placed (the
            reference's nPoints budget, poisson_disk_sampling.py:84);
            None = maximal packing.

    Returns:
        1-D array of selected electrode indices (a maximal-ish packing,
        capped at ``n_points`` when given).
    """
    n = positions.shape[0]
    best = np.array([], np.int64)
    for _ in range(max_restarts):
        selected = []
        taken = np.zeros(n, bool)
        active = [int(rng.integers(n))]
        selected.append(active[0])
        taken[active[0]] = True
        while active and (n_points is None or len(selected) < n_points):
            ai = active[rng.integers(len(active))]
            placed = False
            for _ in range(k):
                # candidate dart in the annulus [r, 2r) around the active pt
                ang = rng.uniform(0, 2 * np.pi)
                rad = rng.uniform(radius, 2 * radius)
                cand = positions[ai] + rad * np.array([np.cos(ang), np.sin(ang)])
                # snap to nearest untaken electrode
                d = np.linalg.norm(positions - cand, axis=1)
                d[taken] = np.inf
                j = int(np.argmin(d))
                if not np.isfinite(d[j]):
                    continue
                # accept if far enough from all selected electrodes
                dsel = np.linalg.norm(
                    positions[selected] - positions[j], axis=1
                )
                if (dsel >= radius).all():
                    selected.append(j)
                    taken[j] = True
                    active.append(j)
                    placed = True
                    break
            if not placed:
                active.remove(ai)
        if len(selected) > len(best):
            best = np.asarray(sorted(selected), np.int64)
        if n_points is not None and len(best) >= n_points:
            break  # budget reached: no later restart can beat it
    return best


def pitch_subsample_sig_channels(positions: np.ndarray, sig_channels,
                                 pitch: float, rng: np.random.Generator,
                                 max_retries: int = 10,
                                 channel_ids: np.ndarray | None = None):
    """Poisson-disk subsample; retry until >=1 significant channel is drawn
    (reference poisson_disk_sampling.py:79-80 recursion).

    ``channel_ids`` maps each ``positions`` row to its channel id so that
    drawn darts compare against ``sig_channels`` in the SAME id space as
    the rest of this module (1-based ``load_sig_channels`` ids). When
    ``None``, position indices themselves are taken as the channel ids
    (a channel-ordered synthetic grid). Returns (selected channel ids,
    indices into ``sig_channels``)."""
    if max_retries < 1:
        raise ValueError("max_retries must be >= 1")
    sig = np.asarray(sig_channels)
    ids = (
        np.arange(len(positions)) if channel_ids is None
        else np.asarray(channel_ids)
    )
    for _ in range(max_retries):
        sel = ids[poisson_disk_sample(positions, pitch, rng)]
        idx = np.where(np.isin(sig, sel))[0]
        if idx.size:
            return sel, idx
    return sel, idx


# physical uECoG array dimensions per patient group: (mm_x, mm_y, max_elec)
# — 128-contact 11.3 x 22.5 mm and 256-contact 37.8 x 20.6 mm arrays
# (reference poisson_disk_sampling.py:38-45; SURVEY.md data facts)
ARRAY_GEOMETRY_MM = {
    **{pt: (11.3, 22.5, 128) for pt in ("S14", "S22", "S23", "S26")},
    **{pt: (37.8, 20.6, 256) for pt in ("S33", "S39", "S58", "S62")},
}


def array_geometry(pt: str):
    """(mm_x, mm_y, max_elec) for a patient's physical electrode array."""
    try:
        return ARRAY_GEOMETRY_MM[pt]
    except KeyError:
        raise KeyError(
            f"no physical array geometry known for patient {pt!r}; "
            f"known: {sorted(ARRAY_GEOMETRY_MM)}"
        ) from None


def pitch_to_n_electrodes(pitch_mm: float, mm_x: float, mm_y: float) -> int:
    """Electrode budget preserving a physical pitch across array sizes
    (poisson_disk_sampling.py:46): n = round(area / pitch^2)."""
    return int(round(mm_x * mm_y / pitch_mm**2))


def pitch_subsample_channels_mm(chan_map: np.ndarray, sig_channels,
                                pitch_mm: float, mm_x: float, mm_y: float,
                                max_elec: int, rng: np.random.Generator,
                                max_retries: int = 10):
    """Physical-pitch electrode subsample on a real channel map.

    The reference flow (poisson_disk_sampling.py:9-82): convert the mm
    pitch to an electrode budget via the array area; if the budget covers
    the whole array, keep every channel; otherwise Poisson-disk sample
    grid positions at spacing ``floor(sqrt(H*W/n))`` (grid units, :52-56),
    map them through the channel map (NaN positions are discarded), top up
    uniformly from unsampled channels when spacing is 1 and the draw ran
    short (:66-74), then intersect with the significant-channel list;
    resample when no significant channel was drawn (:79-80 — retried at
    the SAME pitch; the reference's recursion accidentally passes nElec).

    Returns indices INTO ``sig_channels`` (= the data channel axis).
    """
    sig = np.asarray(sig_channels)
    H, W = chan_map.shape
    n_elec = pitch_to_n_electrodes(pitch_mm, mm_x, mm_y)

    if n_elec >= max_elec:
        elec = np.arange(1, max_elec + 1)
        return np.where(np.isin(sig, elec))[0]

    spacing = max(1.0, np.floor(np.sqrt(H * W / n_elec)))
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    positions = np.stack([ys.ravel(), xs.ravel()], 1).astype(float)

    idx = np.array([], np.int64)
    for _ in range(max_retries):
        sel = poisson_disk_sample(positions, spacing, rng, n_points=n_elec)
        coords = positions[sel].astype(int)
        elec = chan_map[coords[:, 0], coords[:, 1]]
        elec = elec[~np.isnan(elec)].astype(np.int64)
        if len(elec) < n_elec and spacing == 1:
            all_ch = chan_map[~np.isnan(chan_map)].astype(np.int64).ravel()
            remaining = np.setdiff1d(all_ch, elec)
            extra = rng.choice(
                remaining, min(n_elec - len(elec), len(remaining)),
                replace=False,
            )
            elec = np.concatenate([elec, extra])
        idx = np.where(np.isin(sig, elec))[0]
        if idx.size:
            return idx
    return idx


def trial_subsample_indices(y: np.ndarray, n_trials: int,
                            rng: np.random.Generator):
    """Class-balanced random subset of EXACTLY min(n_trials, len(y))
    indices (data-quantity sweeps,
    aligned_decode_cross_patient_subsample.py:290-292).

    Per-class quotas are floor(n/k) with the remainder spread one extra
    trial over randomly-chosen classes, so the sweep's x-axis (trial
    count) is honored even when ``n_trials`` is not a multiple of the
    class count — a silent shortfall would mislabel every sweep point."""
    y = np.asarray(y)
    classes = np.unique(y)
    n_trials = min(n_trials, len(y))
    per = np.full(len(classes), n_trials // len(classes), np.int64)
    per[rng.permutation(len(classes))[: n_trials % len(classes)]] += 1
    picks, short = [], 0
    for c, p in zip(classes, per):
        idx = rng.permutation(np.where(y == c)[0])
        picks.append(idx[:p])
        short += max(0, p - len(idx))
    out = np.concatenate(picks)
    if short:  # thin classes: top up from the unpicked remainder
        rest = np.setdiff1d(np.arange(len(y)), out)
        out = np.concatenate([out, rng.permutation(rest)[:short]])
    rng.shuffle(out)
    return out


def knn_indices(positions: np.ndarray, query: np.ndarray, k: int):
    """Brute-force k nearest electrodes to each query point
    (poisson_disk_sampling.py:202-222)."""
    d = np.linalg.norm(positions[None, :, :] - query[:, None, :], axis=-1)
    return np.argsort(d, axis=1)[:, :k]


def min_neighbor_distance(points: np.ndarray, query: np.ndarray) -> np.ndarray:
    """Distance from each query point to its nearest neighbor in ``points``
    (reference ``poisson_disk_sampling.min_neighbor_distance``, :179-199 —
    the spacing check of the dart-throwing loop). Empty ``points`` ->
    +inf (every throw is valid)."""
    query = np.atleast_2d(query)
    if len(points) == 0:
        return np.full(len(query), np.inf)
    d = np.sqrt(((points[None, :, :] - query[:, None, :]) ** 2).sum(-1))
    return d.min(axis=1)
