"""Synthetic multi-patient micro-ECoG-like data for tests and drivers.

Port of ``cross_patient_speech_decoding_tpu/data/synthetic.py``. Each
patient observes the same shared latent class trajectories through a
random linear readout of its own plus noise, the generative assumption
behind CCA, MCCA and joint-PCA alignment. Trial tensors are
``(n_trials, n_timepoints, n_channels)`` with 3-phoneme sequence labels
over a 9-phoneme vocabulary.

:func:`make_synthetic_patients` is the numpy generator, bit for bit the
JAX package's. :func:`make_synthetic_patients_device` keeps its host part
(trajectory table, sequences, class shuffles) bit for bit too, and draws
the mixing matrices and the noise on the device from a
``torch.Generator``: those draws differ from the JAX twin's
``jax.random`` streams by design, as the JAX twin's differ from numpy's.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from cross_patient_speech_decoding_tpu_torch.ops.precision import hdot
from cross_patient_speech_decoding_tpu_torch.utils.device import (
    resolve_device,
)
from cross_patient_speech_decoding_tpu_torch.utils.labels import (
    encode_label_sequences,
    to_class_ids,
)


@dataclass
class SyntheticDataset:
    """One synthetic multi-patient dataset.

    Attributes:
        X: list of per-patient feature arrays (n_trials, T, channels_p).
        y_seq: list of per-patient (n_trials, seq_len) phoneme sequences.
        y_first: list of per-patient (n_trials,) first-phoneme labels
            (the 9-class classification target of the classical decoders).
        class_ids: list of per-patient (n_trials,) compact sequence-class ids.
        class_universe: sorted encoded sequence values defining the id space.
        latent: (n_classes, T, latent_dim) shared ground-truth trajectories.
        mixings: list of (latent_dim, channels_p) ground-truth readouts.
    """

    X: list = field(default_factory=list)
    y_seq: list = field(default_factory=list)
    y_first: list = field(default_factory=list)
    class_ids: list = field(default_factory=list)
    class_universe: np.ndarray = None
    latent: np.ndarray = None
    mixings: list = field(default_factory=list)

    @property
    def n_classes(self) -> int:
        return len(self.class_universe)


def _smooth_trajectories(rng, n_classes, T, latent_dim):
    """Smooth per-class latent trajectories (random Fourier series)."""
    t = np.linspace(0.0, 1.0, T)
    n_harmonics = 4
    traj = np.zeros((n_classes, T, latent_dim))
    for h in range(1, n_harmonics + 1):
        amp = rng.normal(size=(n_classes, 1, latent_dim)) / h
        phase = rng.uniform(0, 2 * np.pi, size=(n_classes, 1, latent_dim))
        traj += amp * np.sin(2 * np.pi * h * t[None, :, None] + phase)
    return traj


def make_synthetic_patients(
    seed: int = 0,
    n_patients: int = 3,
    n_classes: int = 9,
    trials_per_class: int = 12,
    T: int = 50,
    channels: tuple | int = (48, 64, 56),
    latent_dim: int = 8,
    noise: float = 0.3,
    seq_len: int = 3,
) -> SyntheticDataset:
    """Generate a multi-patient dataset with shared latent structure."""
    rng = np.random.default_rng(seed)
    if isinstance(channels, int):
        channels = tuple(
            int(c) for c in rng.integers(channels // 2, channels + 1, n_patients)
        )
    if len(channels) != n_patients:
        channels = tuple(channels) + tuple(
            int(c) for c in rng.integers(48, 128, n_patients - len(channels))
        )

    # distinct phoneme sequences (vocab 1..9), one per class
    seqs = set()
    while len(seqs) < n_classes:
        seqs.add(tuple(rng.integers(1, 10, seq_len)))
    seqs = np.array(sorted(seqs), dtype=np.int64)

    latent = _smooth_trajectories(rng, n_classes, T, latent_dim)
    universe = np.unique(encode_label_sequences(seqs))

    ds = SyntheticDataset(class_universe=universe, latent=latent)
    for p in range(n_patients):
        n_trials = n_classes * trials_per_class
        cls = np.repeat(np.arange(n_classes), trials_per_class)
        rng.shuffle(cls)
        mixing = rng.normal(size=(latent_dim, channels[p])) / np.sqrt(latent_dim)
        X = latent[cls] @ mixing + noise * rng.normal(
            size=(n_trials, T, channels[p])
        )
        y_seq = seqs[cls]
        ids, _ = to_class_ids(encode_label_sequences(y_seq), universe)
        ds.X.append(X)
        ds.y_seq.append(y_seq)
        ds.y_first.append(y_seq[:, 0].copy())
        ds.class_ids.append(ids)
        ds.mixings.append(mixing)
    return ds


def _host_part(rng, n_patients, n_classes, trials_per_class, T, channels,
               latent_dim, seq_len):
    """The numpy draws of the device twin, in the JAX twin's order:
    (channels, sequences, float32 trajectories, universe, (P, N) class
    rows)."""
    if isinstance(channels, int):
        channels = tuple(
            int(c) for c in rng.integers(channels // 2, channels + 1, n_patients)
        )
    if len(channels) != n_patients:
        channels = tuple(channels) + tuple(
            int(c) for c in rng.integers(48, 128, n_patients - len(channels))
        )

    seqs = set()
    while len(seqs) < n_classes:
        seqs.add(tuple(rng.integers(1, 10, seq_len)))
    seqs = np.array(sorted(seqs), dtype=np.int64)

    latent = _smooth_trajectories(rng, n_classes, T, latent_dim).astype(
        np.float32
    )
    universe = np.unique(encode_label_sequences(seqs))

    cls_list = []
    for _ in range(n_patients):
        cls = np.repeat(np.arange(n_classes), trials_per_class)
        rng.shuffle(cls)
        cls_list.append(cls)
    return channels, seqs, latent, universe, np.stack(cls_list)


def make_synthetic_patients_device(
    seed: int = 0,
    n_patients: int = 3,
    n_classes: int = 9,
    trials_per_class: int = 12,
    T: int = 50,
    channels: tuple | int = (48, 64, 56),
    latent_dim: int = 8,
    noise: float = 0.3,
    seq_len: int = 3,
    device=None,
) -> SyntheticDataset:
    """Device twin of :func:`make_synthetic_patients`.

    Same generative model, but the large Gaussian tensors are drawn on
    ``device`` (default: the first CUDA card; raises without one) from a
    ``torch.Generator`` seeded with ``seed``: first the (P, latent_dim,
    max channels) mixing matrices, then the noise. Only the trajectory
    table and the class rows cross from the host. ``X[p]`` and
    ``mixings[p]`` are views of one (P, N, T, max channels) tensor and of
    the mixing stack, cut to the patient's channels.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    channels, seqs, latent, universe, cls_all = _host_part(
        rng, n_patients, n_classes, trials_per_class, T, channels,
        latent_dim, seq_len)
    n_trials = n_classes * trials_per_class
    c_max = max(channels)

    gen = torch.Generator(device=dev).manual_seed(seed)
    mixes = torch.randn((n_patients, latent_dim, c_max), generator=gen,
                        device=dev) / np.sqrt(latent_dim)
    lat = torch.as_tensor(latent, device=dev)
    lat_sel = lat[torch.as_tensor(cls_all, device=dev)]  # (P, N, T, L)
    X_all = hdot(lat_sel.reshape(n_patients, n_trials * T, latent_dim),
                 mixes).reshape(n_patients, n_trials, T, c_max)
    del lat_sel
    X_all.add_(torch.randn(X_all.shape, generator=gen, device=dev),
               alpha=noise)

    ds = SyntheticDataset(class_universe=universe, latent=latent)
    for p in range(n_patients):
        y_seq = seqs[cls_all[p]]
        ids, _ = to_class_ids(encode_label_sequences(y_seq), universe)
        ds.X.append(X_all[p, :, :, : channels[p]])
        ds.y_seq.append(y_seq)
        ds.y_first.append(y_seq[:, 0].copy())
        ds.class_ids.append(ids)
        ds.mixings.append(mixes[p, :, : channels[p]])
    return ds
