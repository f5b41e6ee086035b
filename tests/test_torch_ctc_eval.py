"""Port CTC loss, greedy decoding, PER and the eval step against JAX.

CTC loss: torch's ctc_loss against optax's recursion, float32 on both
sides, rtol 1e-4. Decoding and edit distances are integer results and
must match exactly.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cross_patient_speech_decoding_tpu.ops.pallas_gru as pg
from cross_patient_speech_decoding_tpu.models import RealtimeRNN as JaxRNN
from cross_patient_speech_decoding_tpu.ops import ctc as jctc
from cross_patient_speech_decoding_tpu.ops import metrics as jmetrics
from cross_patient_speech_decoding_tpu.train.steps import (
    make_ctc_eval_step as jax_eval_step,
)
from cross_patient_speech_decoding_tpu_torch.models import (
    RealtimeRNN,
    realtime_rnn_params_from_flax,
)
from cross_patient_speech_decoding_tpu_torch.ops import ctc, metrics
from cross_patient_speech_decoding_tpu_torch.train import make_ctc_eval_step

torch.set_num_threads(2)


def _ctc_case(seed=0, B=6, T=12, V=5, L=4):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(B, T, V)).astype(np.float32) * 2
    labels = rng.integers(1, V, size=(B, L)).astype(np.int32)
    in_len = rng.integers(L, T + 1, size=B).astype(np.int32)
    lab_len = rng.integers(1, L + 1, size=B).astype(np.int32)
    # infeasible rows: fewer frames than labels, and a repeat that needs
    # a blank between its copies
    in_len[1], lab_len[1] = 2, 4
    labels[2, :3] = [3, 3, 3]
    in_len[2], lab_len[2] = 4, 3
    return logits, in_len, labels, lab_len


@pytest.mark.parametrize("weighted", [False, True])
def test_ctc_loss_mean_matches_optax(weighted):
    logits, il, lab, ll = _ctc_case()
    w = (np.array([1, 0, 1, 2, 1, 0.5], np.float32) if weighted else None)
    got = ctc.ctc_loss_mean(
        torch.from_numpy(logits), torch.from_numpy(il),
        torch.from_numpy(lab), torch.from_numpy(ll),
        weights=None if w is None else torch.from_numpy(w))
    want = jctc.ctc_loss_mean(
        jnp.asarray(logits), jnp.asarray(il), jnp.asarray(lab),
        jnp.asarray(ll), weights=None if w is None else jnp.asarray(w))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)


def test_ctc_loss_zeroes_infeasible_rows():
    logits, il, lab, ll = _ctc_case(seed=1, B=3)
    il[:] = 1  # every row infeasible
    ll[:] = 3
    got = ctc.ctc_loss_mean(*(torch.from_numpy(a)
                              for a in (logits, il, lab, ll)))
    assert float(got) == 0.0


@pytest.mark.parametrize("masked", [False, True])
def test_greedy_decode_matches_jax(masked):
    rng = np.random.default_rng(2)
    B, T, V = 5, 16, 4
    lp = rng.normal(size=(B, T, V)).astype(np.float32)
    # force runs and blanks so the collapse rules matter
    best = rng.integers(0, V, size=(B, T))
    best[:, 5:8] = 2
    lp[np.arange(B)[:, None], np.arange(T)[None, :], best] += 10
    mask = None
    if masked:
        mask = np.ones((B, T), np.int32)
        mask[:, 1::3] = 0  # interleaved: [a, b(masked), a] is one a
        mask[0] = 0  # a row with no valid frame
        mask[1, 10:] = 0
    got, got_len = ctc.greedy_decode(
        torch.from_numpy(lp), 0,
        None if mask is None else torch.from_numpy(mask))
    want, want_len = jctc.greedy_decode(
        jnp.asarray(lp), 0, None if mask is None else jnp.asarray(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))


def test_edit_distance_and_per_match_jax():
    rng = np.random.default_rng(3)
    B, P, L = 40, 9, 6
    pred = rng.integers(0, 4, size=(B, P)).astype(np.int32)
    tgt = rng.integers(1, 4, size=(B, L)).astype(np.int32)
    pl_ = rng.integers(0, P + 1, size=B).astype(np.int32)
    tl = rng.integers(0, L + 1, size=B).astype(np.int32)
    tp = [torch.from_numpy(a) for a in (pred, pl_, tgt, tl)]
    jp = [jnp.asarray(a) for a in (pred, pl_, tgt, tl)]
    got = metrics.edit_distance(*tp).numpy()
    want = np.asarray(jax.vmap(jmetrics.edit_distance)(*jp))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(float(metrics.per_batch(*tp)),
                               float(jmetrics.per_batch(*jp)), rtol=1e-6)


def test_eval_step_matches_jax(monkeypatch):
    """Loss and PER of the port's eval step against JAX
    ``make_ctc_eval_step`` on the kernel path, with short rows (masked
    windows) and an infeasible row."""
    C, B, T = 4, 8, 30
    kw = dict(hidden=16, n_layers=2, n_classes=5, dropout=0.0, win_size=6,
              stride=2)
    jm = JaxRNN(input_grad=False, **kw)
    params = jm.init({"params": jax.random.key(0)},
                     jnp.zeros((1, T, C)), True)
    tm = RealtimeRNN(C, 16, 2, 5, dropout=0.0, win_size=6, stride=2,
                     device="cpu")
    tm.load_state_dict(realtime_rnn_params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))

    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, T, C)).astype(np.float32)
    labels = rng.integers(1, 5, size=(B, 4)).astype(np.int32)
    il = np.array([30, 30, 20, 14, 25, 8, 30, 17], np.int32)
    ll = np.array([4, 3, 4, 2, 1, 4, 4, 3], np.int32)  # row 5: infeasible
    batch = (x, labels, il, ll)

    monkeypatch.setattr(pg, "enabled", lambda: True)
    monkeypatch.setattr(pg, "worthwhile", lambda B, T: True)
    want = jax_eval_step(jm)(SimpleNamespace(params=params["params"]),
                             tuple(jnp.asarray(a) for a in batch))
    got = make_ctc_eval_step(tm)(tuple(torch.from_numpy(a) for a in batch))
    assert got["loss"].device.type == "cpu"
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(got["per"]), float(want["per"]),
                               rtol=1e-6)
