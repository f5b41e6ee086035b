"""Label encoding utilities.

Port of ``cross_patient_speech_decoding_tpu/utils/labels.py`` (numpy only,
kept here as the port's own copy). The reference encodes phoneme-sequence
class labels as joined strings so that sequences act as class keys
(``label2str``/``label_seq2str``); here sequences are encoded as integers.
Because the phoneme vocabulary is the single digits 1..9, positional
encoding reproduces the string-join semantics: lexicographic string order
equals integer order for equal-length sequences, so class orderings
(``np.unique``) agree.
"""

from __future__ import annotations

import numpy as np

# Phoneme (1..9) -> articulator (1..4) collapse map; mirrors the dict at
# reference alignment/alignment_utils.py:197.
PHON_TO_ARTIC = np.array([0, 1, 1, 2, 2, 3, 3, 3, 4, 4], dtype=np.int32)

# Articulator class names (1..4), as used by every figure notebook
# (`figure_analyses/fig_2.ipynb` `artic_labels` cell).
ARTIC_LABELS = np.array(["low", "high", "labial", "dorsal"])

# CTC token table (token id -> phoneme string): the 9-phoneme vocabulary
# plus blank (0) and sil (10) — a file-format/vocabulary contract shared
# with the reference's results h5 (`scripts/train_ctc_rnn.py:35-47`).
PHON_DICT = {
    0: "blank", 1: "a", 2: "ae", 3: "i", 4: "u", 5: "b", 6: "p",
    7: "v", 8: "g", 9: "k", 10: "sil",
}


def phon_to_artic(phon: np.ndarray) -> np.ndarray:
    """Collapse phoneme labels (values 1-9) to articulator labels (1-4)."""
    return PHON_TO_ARTIC[np.asarray(phon, dtype=np.int64)]


def make_chance_labels(
    rng: np.random.Generator,
    n_trials: int,
    seq_length: int,
    n_phonemes: int = 9,
    n_sil: int = 0,
    sil_token: int = 10,
) -> np.ndarray:
    """Fresh uniform-random phoneme sequences with sil padding — the tune
    scripts' chance mode (`scripts/tune_ctc_rnn.py:make_chance_labels`,
    SIL_TOKEN=10 at :47). Distinct from the trainer's permutation chance
    (`train_ctc_rnn.py:155-158`, which preserves the label marginals).

    Returns:
        (n_trials, seq_length) int32 labels; ``n_sil`` sil tokens on each
        side, random phonemes 1..n_phonemes in between.
    """
    inner = seq_length - 2 * n_sil
    if inner <= 0:
        raise ValueError("seq_length must exceed 2 * n_sil")
    labels = rng.integers(
        1, n_phonemes + 1, size=(n_trials, inner)
    ).astype(np.int32)
    if n_sil:
        pad = np.full((n_trials, n_sil), sil_token, np.int32)
        labels = np.concatenate([pad, labels, pad], axis=1)
    return labels


def artic_labels(artic: np.ndarray) -> np.ndarray:
    """Articulator numbers (1-4) -> name strings (notebook
    ``articic_nums2seq``, e.g. `supp/supp_fig_8.ipynb`)."""
    return ARTIC_LABELS[np.asarray(artic, dtype=np.int64) - 1]


def phon_seq_to_artic_str(phon_seq: np.ndarray) -> np.ndarray:
    """Phoneme-sequence rows -> '_'-joined articulator-name strings
    (notebook ``phon2artic_seq``): ``[2, 5, 1] -> 'high_labial_low'``."""
    names = artic_labels(phon_to_artic(np.asarray(phon_seq)))
    return np.array(["_".join(row) for row in np.atleast_2d(names)])


def cv_structure(phon_seq: np.ndarray) -> np.ndarray:
    """Syllable-structure class per sequence row: 'CVC' when the middle
    phoneme is a vowel (token < 5), else 'VCV' (notebook ``labels2cv`` /
    ``labels2cv_seq``, middle-character rule)."""
    seq = np.atleast_2d(np.asarray(phon_seq, dtype=np.int64))
    return np.where(seq[:, 1] < 5, "CVC", "VCV")


def encode_label_sequences(labels: np.ndarray) -> np.ndarray:
    """Encode 1-D labels or 2-D label sequences into scalar integer classes.

    Equivalent to the reference's ``label2str`` (alignment_utils.py:64-80)
    but producing integers: a (N, L) array of tokens becomes base-11 joined
    integers (base 11 so the CTC vocabulary 0..10 incl. the sil token is
    positional-collision-free); a (N,) array passes through as int64. Only
    uniqueness and ordering-per-position matter — the codes are opaque
    class keys.
    """
    labels = np.asarray(labels)
    if labels.ndim == 1:
        return labels.astype(np.int64)
    if labels.ndim != 2:
        raise ValueError(f"labels must be 1-D or 2-D, got shape {labels.shape}")
    if labels.size and (labels.min() < 0 or labels.max() > 10):
        raise ValueError("label tokens must be in 0..10 (CTC vocabulary)")
    out = np.zeros(labels.shape[0], dtype=np.int64)
    for j in range(labels.shape[1]):
        out = out * 11 + labels[:, j].astype(np.int64)
    return out


def to_class_ids(encoded: np.ndarray, universe: np.ndarray | None = None):
    """Map encoded labels to compact contiguous class ids.

    Args:
        encoded: (N,) integer-encoded labels.
        universe: optional sorted array of all class values defining the id
            space. If None, uses np.unique(encoded). Sorted order matches the
            reference's ``np.unique`` over label strings (see module note).

    Returns:
        (class_ids, universe): class_ids is (N,) int32 indices into universe.
    """
    if universe is None:
        universe = np.unique(encoded)
    ids = np.searchsorted(universe, encoded)
    # clipped for the check: a value above the universe's largest raises
    # this ValueError, not an IndexError (as the JAX package's copy does)
    if not np.all(universe[np.minimum(ids, len(universe) - 1)] == encoded):
        raise ValueError("encoded labels contain values outside the universe")
    return ids.astype(np.int32), universe
