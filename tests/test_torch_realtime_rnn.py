"""Port RealtimeRNN against the JAX package's, from one flax init.

Weights go into both packages through ``realtime_rnn_params_from_flax``.
The port rounds the layer-0 frames to bf16 on every device, as the JAX
kernel path does; so against the JAX kernel path (forced on in interpret
mode) logits agree to float32 roundoff (atol 1e-5), and against the JAX
default scan path (unrounded frames) to bf16 input tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cross_patient_speech_decoding_tpu.ops.pallas_gru as pg
from cross_patient_speech_decoding_tpu.models import RealtimeRNN as JaxRNN
from cross_patient_speech_decoding_tpu.models import (
    adjusted_input_lengths as jax_adjusted,
)
from cross_patient_speech_decoding_tpu_torch.models import (
    RealtimeRNN,
    adjusted_input_lengths,
    realtime_rnn_params_from_flax,
    reformat_time_windows,
)

torch.set_num_threads(2)

KW = dict(hidden=32, n_layers=3, n_classes=7, dropout=0.0, win_size=6,
          stride=2)


def _pair(C=5, seed=0, **kw):
    kw = {**KW, **kw}
    jm = JaxRNN(input_grad=False, **kw)
    probe = jnp.zeros((1, 4 * kw["win_size"], C), jnp.float32)
    params = jm.init({"params": jax.random.key(seed)}, probe, True)
    params_np = jax.tree_util.tree_map(np.asarray, params)
    tm = RealtimeRNN(C, kw["hidden"], kw["n_layers"], kw["n_classes"],
                     dropout=kw["dropout"], win_size=kw["win_size"],
                     stride=kw["stride"], device="cpu")
    tm.load_state_dict(realtime_rnn_params_from_flax(params_np))
    tm.eval()
    return jm, params, tm


def _x(B=12, T=40, C=5, seed=0):
    return np.random.default_rng(seed).normal(size=(B, T, C)).astype(
        np.float32)


def test_logits_match_jax_kernel_path(monkeypatch):
    jm, params, tm = _pair()
    x = _x()
    monkeypatch.setattr(pg, "enabled", lambda: True)
    monkeypatch.setattr(pg, "worthwhile", lambda B, T: True)
    want = np.asarray(jm.apply(params, jnp.asarray(x), True))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (12, 18, 7)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_logits_match_jax_scan_path_to_bf16_tolerance():
    jm, params, tm = _pair(seed=1)
    x = _x(seed=1)
    want = np.asarray(jm.apply(params, jnp.asarray(x), True))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    # tests/test_pallas_gru.py:473-474: the bf16 frame cast
    np.testing.assert_allclose(got, want, atol=5e-2, rtol=1e-2)


def test_single_step_matches_jax_single_step():
    jm, params, tm = _pair(seed=2)
    rng = np.random.default_rng(3)
    win = rng.normal(size=(2, 6 * 5)).astype(np.float32)
    h = (rng.normal(size=(3, 2, 32)) * 0.3).astype(np.float32)
    lj, hj = jm.apply(params, jnp.asarray(win), jnp.asarray(h),
                      method=JaxRNN.single_step)
    with torch.no_grad():
        lt, ht = tm.single_step(torch.from_numpy(win), torch.from_numpy(h))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-5)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=1e-5)


def test_initial_hidden_broadcasts_h0():
    jm, params, tm = _pair()
    want = np.asarray(jm.apply(params, 4, method=JaxRNN.initial_hidden))
    np.testing.assert_array_equal(tm.initial_hidden(4).detach().numpy(),
                                  want)


def test_parameter_tree_and_init_follow_flax():
    """Same names and shapes as the flax tree; head bias -2 with +2 on
    blank; init scales of xavier-uniform / orthogonal / lecun-normal."""
    jm, params, tm = _pair()
    flat = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    names = {".".join(p.key for p in path): tuple(v.shape)
             for path, v in flat}
    fresh = RealtimeRNN(5, 32, 3, 7, win_size=6, stride=2, seed=3,
                        device="cpu")
    sd = fresh.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == names
    bias = sd["head.bias"].numpy()
    assert bias[0] == 2.0 and np.all(bias[1:] == -2.0)
    wh = sd["rnn.fwd1.wh"].numpy()
    np.testing.assert_allclose(wh @ wh.T, np.eye(32), atol=1e-5)
    wi = sd["rnn.fwd0.wi"].numpy()
    assert np.abs(wi).max() <= np.sqrt(6.0 / (30 + 96))
    assert np.abs(sd["h0"].numpy()).max() <= np.sqrt(6.0 / (3 * 33))
    k = sd["head.kernel"].numpy()
    assert np.abs(k).max() <= 2 * np.sqrt(1 / 32) / 0.87962566103423978
    # seeded: the same seed gives the same weights
    again = RealtimeRNN(5, 32, 3, 7, win_size=6, stride=2, seed=3,
                        device="cpu").state_dict()
    assert all(torch.equal(sd[n], again[n]) for n in sd)


def test_adjusted_input_lengths_matches_jax():
    lens = np.array([40, 14, 13, 27, 6, 5], np.int32)
    got = adjusted_input_lengths(torch.from_numpy(lens), 6, 2).numpy()
    want = np.asarray(jax_adjusted(jnp.asarray(lens), 6, 2))
    np.testing.assert_array_equal(got, want)


def test_lstm_is_not_ported_yet():
    """The LSTM stack is ported (tests/test_torch_lstm.py holds it against
    JAX): ``cell="lstm"`` builds ``FusedLSTM`` layers, one- and
    two-directional, that return (h, c) stacks; another cell raises."""
    from cross_patient_speech_decoding_tpu_torch.models import (
        FusedLSTM,
        StackedRNN,
    )

    uni = StackedRNN(4, 8, cell="lstm")
    assert isinstance(uni.layer(0), FusedLSTM)
    assert uni.layer(0).wi.shape == (4, 32) and uni.layer(0).b.shape == (32,)
    bi = StackedRNN(4, 8, n_layers=2, bidirectional=True, cell="lstm")
    assert bi.layer(1, "bwd").wi.shape == (16, 32)
    x = torch.from_numpy(_x(B=3, T=5, C=4))
    with torch.no_grad():
        out, (h, c) = bi(x)
    assert out.shape == (3, 5, 16) and h.shape == c.shape == (4, 3, 8)
    with pytest.raises(ValueError, match="cell"):
        StackedRNN(4, 8, cell="rnn")


def test_bidirectional_stack_runs_both_directions():
    """StackedRNN(bidirectional=True): modules fwd{l} and bwd{l}, layer 1
    reads 2H features; out is [forward | reverse] and the last states are
    per layer the forward's at T-1 and the reverse's at 0, each equal to
    its own one-direction layer. With ``window=`` the stack reads the
    windows of the bf16-rounded frames (tests/test_torch_bidir_realtime.py
    holds the bidirectional RealtimeRNN against JAX)."""
    from cross_patient_speech_decoding_tpu_torch.models import StackedRNN

    stack = StackedRNN(4, 8, n_layers=2, bidirectional=True,
                       generator=torch.Generator().manual_seed(0))
    assert stack.layer(1, "bwd").wi.shape == (16, 24)
    x = torch.from_numpy(_x(B=3, T=7, C=4))
    with torch.no_grad():
        out, lasts = stack(x)
        f0, _ = stack.layer(0)(x)
        b0, _ = stack.layer(0, "bwd")(x)
        l0 = torch.cat([f0, b0], dim=-1)
        f1, _ = stack.layer(1)(l0)
        b1, _ = stack.layer(1, "bwd")(l0)
    assert out.shape == (3, 7, 16) and lasts.shape == (4, 3, 8)
    torch.testing.assert_close(out, torch.cat([f1, b1], dim=-1), atol=1e-6,
                               rtol=0)
    want = torch.stack([f0[:, -1], b0[:, 0], f1[:, -1], b1[:, 0]])
    torch.testing.assert_close(lasts, want, atol=1e-6, rtol=0)
    model = RealtimeRNN(5, 8, 1, 3, bidirectional=True, device="cpu")
    assert model.h0.shape == (2, 1, 8) and model.head.kernel.shape == (16, 3)
    wstack = StackedRNN(2 * 4, 8, n_layers=2, bidirectional=True,
                        generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got, got_lasts = wstack(x, window=(2, 1))
        xw = reformat_time_windows(x.to(torch.bfloat16), 2, 1)
        want, want_lasts = wstack(xw)
    assert got.shape == (3, 6, 16)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    torch.testing.assert_close(got_lasts, want_lasts, atol=0, rtol=0)
