"""Latent-trajectory visualization (matplotlib; analysis-layer utility).

Equivalent of the reference's `alignment/alignment_visualization.py:11-243`
grid plots of 1-D/2-D/3-D aligned latent trajectories, used by the figure
notebooks to eyeball alignment quality. Import is lazy so the compute
library never requires matplotlib.

The port's copy of ``cross_patient_speech_decoding_tpu/utils/
visualization.py`` (numpy; matplotlib imported by the plot functions).
"""

from __future__ import annotations

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_latent_trajectories_1d(latents, labels=None, dims=4, save_path=None):
    """Per-dim time courses of condition-averaged latents, views overlaid.

    Args:
        latents: list of (n_classes, T, K) aligned condition averages.
        labels: optional legend names per view.
        dims: number of latent dims to plot.
    """
    plt = _plt()
    n_cls = latents[0].shape[0]
    fig, axes = plt.subplots(
        dims, n_cls, figsize=(2.0 * n_cls, 1.6 * dims), squeeze=False
    )
    for d in range(dims):
        for c in range(n_cls):
            ax = axes[d][c]
            for v, L in enumerate(latents):
                name = labels[v] if labels else f"view {v}"
                ax.plot(np.asarray(L[c, :, d]), lw=1, label=name)
            if d == 0:
                ax.set_title(f"class {c}", fontsize=8)
            if c == 0:
                ax.set_ylabel(f"dim {d}", fontsize=8)
            ax.tick_params(labelsize=6)
    axes[0][0].legend(fontsize=6)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150)
    return fig


def plot_latent_trajectories_2d(latents, dims=(0, 1), labels=None,
                                save_path=None):
    """2-D phase plots of the top two aligned dims per class."""
    plt = _plt()
    n_cls = latents[0].shape[0]
    fig, axes = plt.subplots(1, n_cls, figsize=(2.2 * n_cls, 2.2),
                             squeeze=False)
    i, j = dims
    for c in range(n_cls):
        ax = axes[0][c]
        for v, L in enumerate(latents):
            name = labels[v] if labels else f"view {v}"
            ax.plot(np.asarray(L[c, :, i]), np.asarray(L[c, :, j]), lw=1,
                    label=name)
        ax.set_title(f"class {c}", fontsize=8)
        ax.tick_params(labelsize=6)
    axes[0][0].legend(fontsize=6)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150)
    return fig


def plot_latent_trajectories_3d(latents, dims=(0, 1, 2), labels=None,
                                save_path=None):
    """3-D trajectories of the top three aligned dims, classes as colors."""
    plt = _plt()
    fig = plt.figure(figsize=(5, 5))
    ax = fig.add_subplot(projection="3d")
    i, j, k = dims
    for v, L in enumerate(latents):
        name = labels[v] if labels else f"view {v}"
        for c in range(L.shape[0]):
            ax.plot(
                np.asarray(L[c, :, i]),
                np.asarray(L[c, :, j]),
                np.asarray(L[c, :, k]),
                lw=1,
                alpha=0.8,
                label=name if c == 0 else None,
            )
    ax.legend(fontsize=7)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150)
    return fig


def map_to_channel_grid(data, chan_map):
    """Scatter per-channel values onto a NaN-edged 2-D electrode map.

    ``chan_map`` holds 1-based channel indices with NaN at unused grid
    positions (the `{pt}_channelMap.mat` layout, reference
    `scripts/aligned_decode_grid_subsample.py:26-30`); output cell (i, j)
    is ``data[chan_map[i, j] - 1]`` or NaN. This is the indexing core of
    the ``chan_disp`` helper redefined in every reference figure notebook
    (e.g. `figure_analyses/supp/supp_fig_8.ipynb`).
    """
    chan_map = np.asarray(chan_map, dtype=np.float64)
    data = np.asarray(data, dtype=np.float64)
    flat = chan_map.ravel()
    out = np.full(flat.shape, np.nan)
    valid = ~np.isnan(flat)
    out[valid] = data[flat[valid].astype(np.int64) - 1]
    return out.reshape(chan_map.shape)


def plot_channel_map(data, chan_map, title=None, label=None, clim=None,
                     cmap="viridis", save_path=None):
    """Electrode-grid heatmap of one value per channel (notebook
    ``chan_disp``: clim defaults to mean ± 3 std over the data)."""
    plt = _plt()
    data = np.asarray(data, dtype=np.float64)
    if clim is None:
        m, s = np.nanmean(data), np.nanstd(data)
        clim = (m - 3 * s, m + 3 * s)
    grid = map_to_channel_grid(data, chan_map)
    fig, ax = plt.subplots(figsize=(8, 6))
    im = ax.imshow(grid, cmap=cmap)
    im.set_clim(*clim)
    ax.set_xticks([])
    ax.set_yticks([])
    if title:
        ax.set_title(title)
    cbar = fig.colorbar(im, ax=ax)
    if label:
        cbar.set_label(label)
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
    return fig


def plot_channel_map_seq(data, chan_map, t, t_ranges, row_labels,
                         title=None, label=None, clim=None, cmap="viridis",
                         save_path=None):
    """Grid of electrode-map heatmaps: rows = conditions, columns =
    time windows averaged over ``t in [t0, t1)`` (notebook
    ``chan_disp_seq``; shared clim = mean ± 3 std over all data).

    Args:
        data: (n_rows, T, n_channels) per-condition time-resolved values.
        t: (T,) time axis in seconds.
        t_ranges: list of (t0, t1) half-open windows, one column each.
        row_labels: names per condition row.
    """
    plt = _plt()
    data = np.asarray(data, dtype=np.float64)
    t = np.asarray(t, dtype=np.float64)
    if clim is None:
        m, s = np.nanmean(data), np.nanstd(data)
        clim = (m - 3 * s, m + 3 * s)
    n_rows, n_cols = len(row_labels), len(t_ranges)
    fig, axes = plt.subplots(n_rows, n_cols,
                             figsize=(3.0 * n_cols, 2.4 * n_rows),
                             squeeze=False)
    im = None
    for j, lab in enumerate(row_labels):
        for i, (t0, t1) in enumerate(t_ranges):
            idx = np.where((t >= t0) & (t < t1))[0]
            grid = map_to_channel_grid(data[j, idx].mean(axis=0), chan_map)
            ax = axes[j][i]
            im = ax.imshow(grid, cmap=cmap)
            im.set_clim(*clim)
            ax.set_xticks([])
            ax.set_yticks([])
            if i == 0:
                ax.set_ylabel(lab, fontsize=8)
            if j == 0:
                ax.set_title(f"{t0} -> {t1}s", fontsize=8)
    fig.subplots_adjust(right=0.8)
    cbar = fig.colorbar(im, cax=fig.add_axes((0.84, 0.25, 0.015, 0.5)))
    if label:
        cbar.set_label(label)
    if title:
        fig.suptitle(title)
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
    return fig


def plot_rdm(rdm, labels=None, title=None, cmap="viridis", save_path=None):
    """Representational-dissimilarity-matrix heatmap (fig_6 ``plot_rdm``,
    `figure_analyses/fig_6.ipynb` cell 15)."""
    plt = _plt()
    rdm = np.asarray(rdm)
    fig, ax = plt.subplots(figsize=(6, 5))
    im = ax.imshow(rdm, cmap=cmap)
    fig.colorbar(im, ax=ax)
    if labels is not None:
        ticks = np.arange(len(labels))
        ax.set_xticks(ticks, labels, rotation=90)
        ax.set_yticks(ticks, labels)
    if title:
        ax.set_title(title)
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
    return fig


# --- figure-style summary plots (the fig_4/fig_5/fig_6 panel forms) --------
#
# Style rules (kept deliberately minimal): magnitude-by-category = bars in
# ONE hue (the category axis carries identity; no per-bar colors), chance /
# baseline as a labeled neutral reference line, recessive grid, iteration
# scatter overlaid so the distribution is visible, no rainbow.

_SERIES_HUE = "#2a78d6"
_NEUTRAL = "#52514e"


def _bar_with_points(ax, names, groups, ylabel):
    """Single-hue bars of group means with per-iteration points overlaid."""
    means = [float(np.mean(groups[n])) for n in names]
    ax.bar(names, means, width=0.6, color=_SERIES_HUE, zorder=2)
    rng = np.random.default_rng(0)
    for i, n in enumerate(names):
        vals = np.ravel(np.asarray(groups[n]))
        jitter = rng.uniform(-0.12, 0.12, len(vals))
        ax.scatter(i + jitter, vals, s=9, color="#0b0b0b", alpha=0.45,
                   zorder=3, linewidths=0)
    ax.set_ylabel(ylabel)
    ax.grid(axis="y", color="#dddddd", linewidth=0.6, zorder=0)
    ax.set_axisbelow(True)
    for spine in ("top", "right"):
        ax.spines[spine].set_visible(False)


def plot_group_comparison(groups, ylabel, baseline=None,
                          baseline_label="chance", title=None,
                          save_path=None):
    """Bar panel of a metric across named groups (fig_4's strategy
    comparison / fig_5's context comparison form): group means as
    single-hue bars, per-iteration values as points, optional labeled
    baseline line.

    Args:
        groups: ordered mapping name -> array of per-iteration values.
        ylabel: metric name (e.g. 'balanced accuracy', 'PER (%)').
        baseline: optional horizontal reference (e.g. chance level).
    """
    plt = _plt()
    names = list(groups)
    fig, ax = plt.subplots(figsize=(1.1 + 0.9 * len(names), 3.0))
    _bar_with_points(ax, names, groups, ylabel)
    if baseline is not None:
        ax.axhline(baseline, color=_NEUTRAL, linewidth=1.0,
                   linestyle="--", zorder=1)
        ax.annotate(
            baseline_label, (0.99, baseline),
            xycoords=("axes fraction", "data"), ha="right", va="bottom",
            fontsize=8, color=_NEUTRAL,
            bbox=dict(boxstyle="round,pad=0.15", facecolor="white",
                      edgecolor="none", alpha=0.8),
        )
    if title:
        ax.set_title(title, fontsize=10)
    plt.setp(ax.get_xticklabels(), rotation=20, ha="right")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150)
        plt.close(fig)
        return None  # closed figures are not for further use
    return fig


def plot_scaling_curve(ks, values, ylabel, fit=None, save_path=None,
                       xlabel="training trials"):
    """fig_5's data-scaling panel: metric vs trial count on a log-x
    axis with the per-k distribution and an optional log-linear fit
    overlay (utils.scaling.log_linear_fit output)."""
    plt = _plt()
    ks = np.asarray(ks, float)
    vals = [np.ravel(np.asarray(v)) for v in values]
    means = np.array([v.mean() for v in vals])
    fig, ax = plt.subplots(figsize=(4.2, 3.0))
    for k, v in zip(ks, vals):
        ax.scatter(np.full(len(v), k), v, s=9, color="#0b0b0b",
                   alpha=0.35, linewidths=0, zorder=2)
    ax.plot(ks, means, color=_SERIES_HUE, linewidth=2.0, marker="o",
            markersize=5, zorder=3, label="mean")
    if fit is not None:
        xs = np.geomspace(ks.min(), ks.max(), 50)
        ys = fit["predict"](xs)  # log-log fit in original units
        ax.plot(xs, ys, color=_NEUTRAL, linewidth=1.2, linestyle="--",
                zorder=1, label=f"log-linear (slope {fit['slope']:.2f})")
        ax.legend(frameon=False, fontsize=8)
    ax.set_xscale("log")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.grid(axis="y", color="#dddddd", linewidth=0.6, zorder=0)
    ax.set_axisbelow(True)
    for spine in ("top", "right"):
        ax.spines[spine].set_visible(False)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=150)
        plt.close(fig)
        return None  # closed figures are not for further use
    return fig


def save_panel(out_dir, name, plot_fn, *args, **kwargs):
    """Save one figure panel PNG under ``out_dir`` (created if needed)
    and report it — the shared tail of every example flow's ``out_dir``
    option. Returns the written path."""
    from pathlib import Path

    d = Path(out_dir)
    d.mkdir(parents=True, exist_ok=True)
    path = str(d / name)
    plot_fn(*args, save_path=path, **kwargs)
    print(f"wrote {path}", flush=True)
    return path
