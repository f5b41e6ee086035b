"""Port streaming decoder: DSP against scipy and JAX, the stream against
JAX ``simulate_stream``, and online against offline.

DSP runs in float32 against float64 scipy: atol 1e-5. Each GRU window
goes in float32, as in JAX ``single_step``, so per-chunk logits agree
with JAX to 1e-5. The offline forward rounds its layer-0 frames to bf16,
so online and offline agree to the bound the JAX package holds between
those two paths (5e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps
import torch

from cross_patient_speech_decoding_tpu.models import RealtimeRNN as JaxRNN
from cross_patient_speech_decoding_tpu.ops import signal as jsignal
from cross_patient_speech_decoding_tpu.realtime import (
    init_realtime_state as jax_init_state,
)
from cross_patient_speech_decoding_tpu.realtime import (
    simulate_stream as jax_simulate,
)
from cross_patient_speech_decoding_tpu_torch.models import (
    RealtimeRNN,
    realtime_rnn_params_from_flax,
)
from cross_patient_speech_decoding_tpu_torch.ops import signal
from cross_patient_speech_decoding_tpu_torch.realtime import (
    init_realtime_state,
    make_realtime_step,
    simulate_stream,
)

torch.set_num_threads(2)


def _bands(n_bands=2, order=4):
    bs, as_ = [], []
    for i in range(n_bands):
        b, a = sps.butter(order // 2, [0.15 + 0.2 * i, 0.3 + 0.2 * i],
                          "band")
        bs.append(b)
        as_.append(a)
    return np.stack(bs), np.stack(as_)


def _f32(a):
    return torch.as_tensor(a, dtype=torch.float32)


def test_lfilter_zi_matches_scipy():
    b, a = sps.butter(2, [0.2, 0.4], btype="band")
    np.testing.assert_allclose(signal.lfilter_zi(b, a),
                               sps.lfilter_zi(b, a), atol=1e-10)


def test_car_excludes_bad_channels():
    x = np.random.default_rng(0).normal(size=(6, 40))
    good = np.ones(6)
    good[[1, 4]] = 0
    got = signal.car(_f32(x), _f32(good)).numpy()
    np.testing.assert_allclose(got, x - x[[0, 2, 3, 5]].mean(axis=0),
                               atol=1e-5)
    np.testing.assert_allclose(signal.car(_f32(x)).numpy(),
                               x - x.mean(axis=0), atol=1e-5)


def test_iir_carried_state_matches_scipy_lfilter():
    """Chunked filtering with carried zi equals one scipy lfilter pass
    over the whole signal, and the final state equals scipy's zf."""
    rng = np.random.default_rng(1)
    C, T, chunk = 4, 120, 10
    x = rng.normal(size=(C, T))
    b, a = _bands(3)
    zi0 = np.stack([np.tile(sps.lfilter_zi(b[i], a[i]), (C, 1))
                    for i in range(3)])
    want = np.zeros((C, T, 3))
    zf_want = np.zeros_like(zi0)
    for i in range(3):
        want[:, :, i], zf_want[i] = sps.lfilter(b[i], a[i], x, zi=zi0[i])
    z = _f32(zi0)
    outs = []
    for s in range(0, T, chunk):
        y, z = signal.iir_filter_stateful(_f32(x[:, s:s + chunk]), _f32(b),
                                          _f32(a), z)
        outs.append(y.numpy())
    np.testing.assert_allclose(np.concatenate(outs, axis=1), want, atol=1e-5)
    np.testing.assert_allclose(z.numpy(), zf_want, atol=1e-5)


def test_process_hg_chunk_matches_jax():
    rng = np.random.default_rng(2)
    C = 5
    b, a = _bands()
    st = signal.init_stream_state(b, a, C, device="cpu")
    jst = jsignal.init_stream_state(b, a, C)
    np.testing.assert_allclose(st.zi.numpy(), np.asarray(jst.zi), atol=1e-6)
    for _ in range(3):
        ch = rng.normal(size=(C, 10)).astype(np.float32)
        p, st = signal.process_hg_chunk(_f32(ch), _f32(b), _f32(a), st)
        jp, jst = jsignal.process_hg_chunk(
            jnp.asarray(ch), jnp.asarray(b, jnp.float32),
            jnp.asarray(a, jnp.float32), jst)
        np.testing.assert_allclose(p.numpy(), np.asarray(jp), atol=1e-5)
    np.testing.assert_allclose(st.zi.numpy(), np.asarray(jst.zi), atol=1e-5)


def _models(C, seed=0, **kw):
    """One flax init in both packages. The head's blank bias is removed
    and its kernel scaled so that the random model emits symbols."""
    jm = JaxRNN(**kw)
    params = jax.tree_util.tree_map(
        np.array, jm.init(jax.random.key(seed), jnp.zeros((1, 40, C))))
    params["params"]["head"]["bias"][:] = 0.0
    params["params"]["head"]["kernel"] *= 4.0
    tm = RealtimeRNN(C, kw["hidden"], kw["n_layers"], kw["n_classes"],
                     win_size=kw["win_size"], stride=kw["stride"],
                     device="cpu")
    tm.load_state_dict(realtime_rnn_params_from_flax(params))
    tm.eval()
    return jm, jax.tree_util.tree_map(jnp.asarray, params), tm


def test_stream_matches_jax_and_offline():
    C, bin_len, n_chunks = 6, 10, 30
    kw = dict(hidden=12, n_layers=2, n_classes=5, win_size=8, stride=3)
    jm, params, tm = _models(C, seed=1, **kw)
    chunks = np.random.default_rng(0).normal(
        size=(n_chunks, C, bin_len)).astype(np.float32)
    b, a = _bands()
    bt, at = _f32(b), _f32(a)

    state = init_realtime_state(tm, b, a, C)
    final, (emitted, logits, did_run) = simulate_stream(
        tm, state, torch.from_numpy(chunks), bt, at)
    jstate = jax_init_state(jm, params, b, a, C)
    _, (j_emit, j_logits, j_ran) = jax_simulate(
        jm, params, jstate, jnp.asarray(chunks), jnp.asarray(b, jnp.float32),
        jnp.asarray(a, jnp.float32))

    np.testing.assert_array_equal(did_run.numpy(), np.asarray(j_ran))
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                               atol=1e-5)
    np.testing.assert_array_equal(emitted.numpy(), np.asarray(j_emit))
    assert (emitted >= 0).sum() >= 2  # the comparison is not all-blank
    assert final.n_bins == n_chunks

    # offline: the same DSP powers through the windowed forward
    st = signal.init_stream_state(b, a, C, device="cpu")
    powers = []
    for ch in chunks:
        p, st = signal.process_hg_chunk(torch.from_numpy(ch), bt, at, st)
        powers.append(p)
    with torch.no_grad():
        offline = tm(torch.stack(powers)[None])[0].numpy()
    online = logits.numpy()[did_run.numpy()]
    assert online.shape == offline.shape
    # offline rounds its layer-0 frames to bf16, online does not: the
    # JAX package's own bound between the two (tests/test_realtime.py:57)
    np.testing.assert_allclose(online, offline, atol=5e-3)
    path = offline.argmax(-1)
    collapsed = [int(s) for i, s in enumerate(path)
                 if s != 0 and (i == 0 or s != path[i - 1])]
    assert [int(s) for s in emitted.numpy() if s >= 0] == collapsed


@pytest.mark.parametrize("win,stride", [(6, 2), (5, 3)])
def test_step_cadence_follows_model_geometry(win, stride):
    """First GRU step after win bins, then every stride bins."""
    C = 4
    tm = RealtimeRNN(C, 8, 1, 4, win_size=win, stride=stride, device="cpu")
    b, a = _bands()
    state = init_realtime_state(tm, b, a, C)
    step = make_realtime_step(tm)
    ran = []
    for ch in np.random.default_rng(4).normal(size=(14, C, 5)):
        state, (_, _, did) = step(state, _f32(ch), _f32(b), _f32(a))
        ran.append(did)
    assert ran == [n >= win and (n - win) % stride == 0
                   for n in range(1, 15)]
