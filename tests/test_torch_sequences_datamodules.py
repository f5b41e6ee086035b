"""The port's ``ops/sequences.py``, MixUp and time-jitter augmentations and
``data/datamodules.py`` against the JAX package's, on the CPU.

Host-side functions must equal JAX's exactly. The seq2seq predictions come
from one flax init in both packages, JAX's products at full float32; they
must be equal, every fed-back argmax having a top-2 margin above 1e-4. The
augmentations' draws come from different generators in the two packages,
so the draws are checked by their statistics and the applies on JAX's own
draws (atol 1e-6). The folds run on the same splits (both packages draw
them from one ``np.random.Generator`` sequence): ``simple_folds`` and
``ctc_holdout`` exactly; ``aligned_folds``' target latents to 2e-4 and its
CCA-mapped sources to 1e-3 of their largest value (the bounds of
tests/test_torch_alignment.py and the CTC driver's), after each target
component takes JAX's sign (a principal component's sign is free, and the
packages' eigensolvers choose it differently).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_patient_speech_decoding_tpu.data import datamodules as jdm
from cross_patient_speech_decoding_tpu.data.synthetic import (
    make_synthetic_patients,
)
from cross_patient_speech_decoding_tpu.decoders.pooled import (
    PatientArrays as JaxPatient,
)
from cross_patient_speech_decoding_tpu.models import Seq2SeqRNN as JaxSeq2Seq
from cross_patient_speech_decoding_tpu.ops import augment as jaug
from cross_patient_speech_decoding_tpu.ops import sequences as jseq
from cross_patient_speech_decoding_tpu_torch.data import datamodules as dm
from cross_patient_speech_decoding_tpu_torch.decoders.pooled import (
    PatientArrays,
)
from cross_patient_speech_decoding_tpu_torch.models import (
    Seq2SeqRNN,
    seq2seq_params_from_flax,
)
from cross_patient_speech_decoding_tpu_torch.ops import augment as aug
from cross_patient_speech_decoding_tpu_torch.ops import sequences as seq

torch.set_num_threads(2)

APPLY_ATOL = 1e-6
PCA_RTOL = 2e-4
ALIGNED_RTOL = 1e-3


# --------------------------------------------------------------- sequences --


def test_host_sequence_helpers_equal_jax():
    rng = np.random.default_rng(0)
    y = rng.integers(0, 9, size=(7, 3)).astype(np.int32)
    for got, want in zip(seq.pad_sequence_teacher_forcing(y, 9),
                         jseq.pad_sequence_teacher_forcing(y, 9)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    got, want = seq.one_hot_seq(y, 9), jseq.one_hot_seq(y, 9)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    probs = rng.random(size=(4, 3, 6))
    np.testing.assert_array_equal(seq.one_hot_decode_batch(probs),
                                  jseq.one_hot_decode_batch(probs))
    ragged = [rng.integers(0, 9, size=n) for n in (3, 0, 5)] + [
        rng.integers(0, 9, size=(2, 3))]
    np.testing.assert_array_equal(seq.flatten_fold_preds(ragged),
                                  jseq.flatten_fold_preds(ragged))


def test_seq2seq_predict_and_decode_equal_jax():
    """Greedy decode in eval mode (running statistics off their init), no
    teacher forcing; the model's training flag is restored."""
    B, T, C, NCLS = 9, 16, 3, 5
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, T, C)).astype(np.float32)
    y = rng.integers(0, NCLS, size=(B, 3)).astype(np.int32)
    jm = JaxSeq2Seq(n_filters=6, hidden=10, num_classes=NCLS, kernel_size=4)
    v = jax.jit(lambda k: jm.init({"params": k, "tf": k}, jnp.asarray(x),
                                  jnp.asarray(y), 0.5, False))(
        jax.random.key(2))
    ar = jnp.arange(6, dtype=jnp.float32)
    v = {"params": v["params"], "batch_stats": {"TemporalConv_0": {
        "BatchNorm_0": {"mean": 0.05 * ar, "var": 1.0 + 0.2 * ar}}}}
    v = jax.tree_util.tree_map(np.asarray, v)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(lambda v, x: jseq.seq2seq_predict_batch(
            jm, v, x))(v, jnp.asarray(x)))
        logits = np.asarray(jax.jit(lambda v, x: jm.apply(
            v, x, None, 0.0, True))(v, jnp.asarray(x)))
    top2 = np.sort(logits, axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > 1e-4
    tm = Seq2SeqRNN(C, 6, 10, NCLS, kernel_size=4, device="cpu")
    tm.load_state_dict(seq2seq_params_from_flax(v["params"],
                                                v["batch_stats"]))
    tm.train()
    got = seq.seq2seq_predict_batch(tm, x)
    assert tm.training and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # JAX's decode_seq2seq: its batch prediction and the labels, raveled
    pred, true = seq.decode_seq2seq(tm, torch.from_numpy(x), y)
    np.testing.assert_array_equal(pred, want.ravel())
    np.testing.assert_array_equal(true, y.ravel())


# ----------------------------------------------------------- augmentations --


def test_x_key_gives_each_index_its_own_stream():
    """Same (seed, i): the same stream, whether the seed comes as an int or
    a generator; another i or seed: another stream; the generator given
    is not advanced."""
    g = torch.Generator().manual_seed(7)
    before = g.get_state()
    draws = {i: torch.rand(4, generator=aug.x_key(g, i)) for i in range(3)}
    assert torch.equal(g.get_state(), before)
    assert torch.equal(draws[1], torch.rand(4, generator=aug.x_key(7, 1)))
    assert not torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0],
                           torch.rand(4, generator=aug.x_key(8, 0)))


def test_mixup_pairs_draws_by_statistics():
    """a uniform over the trials, b uniform over a's class (a itself for a
    class of one): frequencies within 5 standard errors of uniform."""
    ids = torch.tensor([0, 0, 1, 1, 1, 2, 0, 1, 3, 1])
    n_aug = 40000
    a, b = aug.mixup_pairs(torch.Generator().manual_seed(0), ids, 4, n_aug)
    assert a.dtype == b.dtype == torch.int32
    assert torch.equal(ids[a.long()], ids[b.long()])
    freq = torch.bincount(a.long(), minlength=10).double() / n_aug
    assert (freq - 0.1).abs().max() <= 5 * (0.1 * 0.9 / n_aug) ** 0.5
    for cls in (0, 1):
        members = (ids == cls).nonzero().flatten()
        sel = b[ids[a.long()] == cls].long()
        p = 1.0 / len(members)
        f = torch.bincount(sel, minlength=10)[members].double() / len(sel)
        assert (f - p).abs().max() <= 5 * (p * (1 - p) / len(sel)) ** 0.5
    lone = ids[a.long()] == 2
    assert torch.equal(b[lone], a[lone])


def test_mixup_pairs_apply_on_jax_draws():
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 4, size=25).astype(np.int32)
    key = jax.random.key(5)
    k1, k2 = jax.random.split(key)
    idx_a = np.asarray(jax.random.randint(k1, (64,), 0, 25))
    gumbel = np.asarray(jax.random.gumbel(k2, (64, 25)))
    got = aug.mixup_pairs_apply(torch.from_numpy(ids),
                                (torch.tensor(idx_a), torch.tensor(gumbel)))
    want = jaug.mixup_pairs(key, jnp.asarray(ids), 4, 64)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_mixup_lam_by_statistics_and_no_global_rng():
    """lam ~ Beta(0.5, 0.5): mean 1/2 and variance 1/8 within 5 standard
    errors over 20000 draws; the mixture lies between its two trials; the
    global torch and numpy random states are left alone."""
    ids = torch.tensor([0, 1, 0, 1, 2, 2])
    X = torch.arange(6 * 4, dtype=torch.float32).reshape(6, 2, 2)
    torch_state = torch.get_rng_state()
    np_state = np.random.get_state()[1].copy()
    g = torch.Generator().manual_seed(1)
    _, lam = aug.mixup_draw(g, ids, 20000, 0.5)
    assert torch.equal(torch.get_rng_state(), torch_state)
    np.testing.assert_array_equal(np.random.get_state()[1], np_state)
    n = lam.numel()
    assert lam.dtype == torch.float32 and bool(((lam >= 0) & (lam <= 1)).all())
    assert abs(float(lam.mean()) - 0.5) <= 5 * (0.125 / n) ** 0.5
    # the sample variance's standard error, from the fourth central moment
    # of Beta(1/2, 1/2), 3/128
    se_var = ((3 / 128 - 0.125**2) / n) ** 0.5
    assert abs(float(lam.var()) - 0.125) <= 5 * se_var
    X_aug, ids_aug = aug.mixup(torch.Generator().manual_seed(2), X, ids, 3,
                               500, 0.5)
    assert X_aug.shape == (500, 2, 2)
    a, b = aug.mixup_pairs(torch.Generator().manual_seed(2), ids, 3, 500)
    lo = torch.minimum(X[a.long()], X[b.long()])
    hi = torch.maximum(X[a.long()], X[b.long()])
    assert bool(((X_aug >= lo - 1e-5) & (X_aug <= hi + 1e-5)).all())
    assert torch.equal(ids_aug, ids[a.long()])


def test_mixup_apply_on_jax_draws():
    rng = np.random.default_rng(4)
    X = rng.normal(size=(20, 5, 3)).astype(np.float32)
    ids = rng.integers(0, 3, size=20).astype(np.int32)
    key = jax.random.key(9)
    k_pairs, k_lam = jax.random.split(key)
    k1, k2 = jax.random.split(k_pairs)
    draws = ((torch.tensor(np.asarray(jax.random.randint(k1, (30,), 0, 20))),
              torch.tensor(np.asarray(jax.random.gumbel(k2, (30, 20))))),
             torch.tensor(np.asarray(jax.random.beta(k_lam, 0.4, 0.4,
                                                     (30,)))))
    X_aug, ids_aug = aug.mixup_apply(torch.from_numpy(X),
                                     torch.from_numpy(ids), draws)
    X_j, ids_j = jaug.mixup(key, jnp.asarray(X), jnp.asarray(ids), 3, 30,
                            alpha=0.4)
    np.testing.assert_allclose(X_aug.numpy(), np.asarray(X_j),
                               atol=APPLY_ATOL)
    np.testing.assert_array_equal(ids_aug.numpy(), np.asarray(ids_j))


def test_time_jitter_windows_equal_jax():
    """Crops at center + offset, each start clamped to [0, T_wide - win]."""
    X = np.random.default_rng(5).normal(size=(3, 20, 2)).astype(np.float32)
    offsets = (-9, -2, 0, 3, 15)
    got = aug.time_jitter_windows(torch.from_numpy(X), 6, 8, offsets)
    want = jaug.time_jitter_windows(jnp.asarray(X), 6, 8, offsets)
    assert got.shape == (5, 3, 8, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[0].numpy(), X[:, 0:8])
    np.testing.assert_array_equal(got[4].numpy(), X[:, 12:20])


# -------------------------------------------------------------- datamodules --


def _assert_folds_equal(got, want):
    assert len(got) == len(want)
    for fg, fw in zip(got, want):
        for part in ("train", "val", "test"):
            for a, b in zip(getattr(fg, part), getattr(fw, part)):
                np.testing.assert_array_equal(a, np.asarray(b))


def test_simple_folds_equal_jax_with_identity_augmentation():
    rng = np.random.default_rng(6)
    X = rng.normal(size=(48, 6, 3)).astype(np.float32)
    y = np.repeat(np.arange(4), 12).astype(np.int32)
    seen = []

    def ident(gen, X_tr, y_tr):
        seen.append(gen.initial_seed())
        return X_tr, y_tr

    got = dm.simple_folds(X, y, n_folds=4, val_frac=0.15, seed=3,
                          augment=ident, device="cpu")
    want = jdm.simple_folds(X, y, n_folds=4, val_frac=0.15, seed=3,
                            augment=lambda k, X_tr, y_tr: (X_tr, y_tr))
    _assert_folds_equal(got, want)
    assert seen == [3000, 3001, 3002, 3003]
    assert len(got[0].train[1]) == 2 * (48 - len(got[0].val[1])
                                        - len(got[0].test[1]))
    _assert_folds_equal(dm.simple_folds(X, y, n_folds=5, seed=1),
                        jdm.simple_folds(X, y, n_folds=5, seed=1))


def test_ctc_holdout_equal_jax():
    def mk(n, seed):
        r = np.random.default_rng(seed)
        return (r.normal(size=(n, 20, 4)).astype(np.float32),
                r.integers(1, 5, (n, 2)), np.full(n, 20), np.full(n, 2))

    for datasets in ([mk(30, 0)], [mk(30, 0), mk(12, 1), mk(7, 2)]):
        got = dm.ctc_holdout(datasets, val_frac=0.1, test_frac=0.2, seed=4)
        want = jdm.ctc_holdout(datasets, val_frac=0.1, test_frac=0.2, seed=4)
        _assert_folds_equal([got], [want])


@pytest.mark.parametrize("align_before_split", [False, True])
def test_aligned_folds_match_jax(align_before_split):
    """Both split orders: the same rows in every part, the target latents
    and the pooled, CCA-mapped sources within their bounds."""
    ds = make_synthetic_patients(seed=5, n_patients=3, n_classes=5,
                                 trials_per_class=10, T=12,
                                 channels=(10, 8, 9), latent_dim=4,
                                 noise=0.2)
    mk = [(np.asarray(ds.X[p], np.float32),
           np.asarray(ds.class_ids[p], np.int32)) for p in range(3)]
    pts_t = [PatientArrays(torch.from_numpy(X), torch.from_numpy(y),
                           torch.from_numpy(y)) for X, y in mk]
    pts_j = [JaxPatient(jnp.asarray(X), jnp.asarray(y), jnp.asarray(y))
             for X, y in mk]
    kw = dict(n_folds=2, n_comp=0.9, max_k=6, seed=2,
              align_before_split=align_before_split)
    got = dm.aligned_folds(pts_t[0], pts_t[1:], ds.n_classes, **kw)
    with jax.default_matmul_precision("highest"):
        want = jdm.aligned_folds(pts_j[0], pts_j[1:], ds.n_classes, **kw)
    assert len(got) == len(want) == 2
    T = mk[0][0].shape[1]
    n_src = sum(len(y) for _, y in mk[1:])
    for fg, fw in zip(got, want):
        for part in ("val", "test"):
            np.testing.assert_array_equal(getattr(fg, part)[1],
                                          np.asarray(getattr(fw, part)[1]))
        np.testing.assert_array_equal(fg.train[1], np.asarray(fw.train[1]))
        # each target component's sign from the fold's target rows
        tar_g = np.concatenate([fg.val[0], fg.test[0]]).reshape(-1, T, 6)
        tar_w = np.concatenate([np.asarray(fw.val[0]),
                                np.asarray(fw.test[0])]).reshape(-1, T, 6)
        sign = np.where((tar_g * tar_w).sum((0, 1)) < 0, -1.0, 1.0)
        flip = np.tile(sign, T)
        for part in ("val", "test"):
            w = np.asarray(getattr(fw, part)[0])
            np.testing.assert_allclose(getattr(fg, part)[0] * flip, w,
                                       atol=PCA_RTOL * np.abs(w).max())
        n_tar = len(fg.train[1]) - n_src
        w = np.asarray(fw.train[0])
        np.testing.assert_allclose(fg.train[0][:n_tar] * flip, w[:n_tar],
                                   atol=PCA_RTOL * np.abs(w[:n_tar]).max())
        np.testing.assert_allclose(fg.train[0][n_tar:] * flip, w[n_tar:],
                                   atol=ALIGNED_RTOL * np.abs(w[n_tar:]).max())
