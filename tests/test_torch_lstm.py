"""The port's LSTM (``FusedLSTM``, the ``cell="lstm"`` paths of
``StackedRNN``, ``EncoderRNN``, ``DecoderRNN`` and ``Seq2SeqRNN``) against
the JAX package's, on the CPU.

The same numpy inputs, and one flax init carried over by
``seq2seq_params_from_flax`` (which carries the LSTM's one bias ``b``), go
to both packages. JAX's LSTM is a ``lax.scan`` with no Pallas kernel; its
products are pinned to full float32 (``jax.default_matmul_precision
("highest")``), so outputs agree to float32 roundoff: atol 1e-5 on states
and logits, every gradient to 5e-6 x its largest value, and after each of
two AdamW train steps every parameter to atol 2e-6 (as
tests/test_torch_seq2seq.py). ``torch.nn.LSTM`` with the same weights is
an independent check of the gate order and the summed bias (atol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_patient_speech_decoding_tpu.models import FusedLSTM as JaxLSTM
from cross_patient_speech_decoding_tpu.models import Seq2SeqRNN as JaxSeq2Seq
from cross_patient_speech_decoding_tpu.models.layers import (
    StackedRNN as JaxStackedRNN,
)
from cross_patient_speech_decoding_tpu.train import (
    create_train_state as jax_create_state,
)
from cross_patient_speech_decoding_tpu.train import loops as jloops
from cross_patient_speech_decoding_tpu.train.steps import (
    make_seq2seq_train_step as jax_train_step,
)
from cross_patient_speech_decoding_tpu_torch.models import (
    FusedLSTM,
    Seq2SeqRNN,
    StackedRNN,
    seq2seq_params_from_flax,
)
from cross_patient_speech_decoding_tpu_torch.models import torch_import as ti
from cross_patient_speech_decoding_tpu_torch.train import (
    create_train_state,
    make_optimizer,
    make_seq2seq_train_step,
)

torch.set_num_threads(2)

ATOL = 1e-5
GRAD_RTOL = 5e-6
PARAM_ATOL = 2e-6
B, T, C, NF, H, K, L, NCLS = 5, 14, 3, 6, 10, 4, 3, 5
KW = dict(n_filters=NF, hidden=H, num_classes=NCLS, kernel_size=K,
          cell="lstm", n_enc_layers=2, n_dec_layers=2)
STEPS = 2


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _flat(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {".".join(p.key for p in path): np.array(v) for path, v in flat}


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in _flat(tree).items()}


def _rand(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("carry", [False, True])
def test_fused_lstm_matches_jax(reverse, carry):
    """Outputs and the last (h, c), from a zero carry or a given one."""
    rng = np.random.default_rng(1)
    x = _rand(rng, B, 7, 6)
    c0 = (_rand(rng, B, 9, scale=0.3), _rand(rng, B, 9, scale=0.3))
    jm = JaxLSTM(9, reverse=reverse)
    params = _np(jm.init(jax.random.key(0), jnp.asarray(x)))
    with jax.default_matmul_precision("highest"):
        hs_j, (h_j, c_j) = jax.jit(jm.apply)(
            params, jnp.asarray(x),
            tuple(map(jnp.asarray, c0)) if carry else None)
    tm = FusedLSTM(6, 9, reverse=reverse)
    tm.load_state_dict(_t(params["params"]))
    with torch.no_grad():
        hs, (h, c) = tm(torch.from_numpy(x),
                        tuple(map(torch.from_numpy, c0)) if carry else None)
    for got, want in ((hs, hs_j), (h, h_j), (c, c_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("bidirectional,h0", [
    (False, "tuple"), (False, "bare"), (True, "tuple"), (True, "bare"),
    (True, None)])
def test_stacked_lstm_matches_jax(bidirectional, h0):
    """Two layers: out and the (h, c) stacks of last states; a tuple
    ``h0`` of (n_layers * n_dir, B, H) stacks, or a bare one (h, zero
    c)."""
    rng = np.random.default_rng(2)
    n_dir = 2 if bidirectional else 1
    x = _rand(rng, B, 8, 4)
    hh = _rand(rng, 2 * n_dir, B, 7, scale=0.3)
    cc = _rand(rng, 2 * n_dir, B, 7, scale=0.3)
    h0_np = {"tuple": (hh, cc), "bare": hh, None: None}[h0]
    jm = JaxStackedRNN(7, 2, bidirectional=bidirectional, cell="lstm")
    params = _np(jm.init(jax.random.key(1), jnp.asarray(x)))
    to_j = (lambda a: tuple(map(jnp.asarray, a)) if isinstance(a, tuple)
            else None if a is None else jnp.asarray(a))
    with jax.default_matmul_precision("highest"):
        out_j, (h_j, c_j) = jax.jit(jm.apply)(params, jnp.asarray(x),
                                              to_j(h0_np))
    tm = StackedRNN(4, 7, 2, bidirectional=bidirectional, cell="lstm")
    tm.load_state_dict(_t(params["params"]))
    to_t = (lambda a: tuple(map(torch.from_numpy, a)) if isinstance(a, tuple)
            else None if a is None else torch.from_numpy(a))
    with torch.no_grad():
        out, (h, c) = tm(torch.from_numpy(x), to_t(h0_np))
    assert out.shape == (B, 8, 7 * n_dir) and h.shape == (2 * n_dir, B, 7)
    for got, want in ((out, out_j), (h, h_j), (c, c_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_fused_lstm_matches_torch_nn_lstm():
    """``torch.nn.LSTM`` with the same weights (``lstm_params_from_torch``:
    transposed kernels, the two biases summed), forward and reversed."""
    torch.manual_seed(3)
    ref = torch.nn.LSTM(6, 9, batch_first=True, bidirectional=True)
    sd = {f"rnn.{k}": v.numpy() for k, v in ref.state_dict().items()}
    x = torch.randn(B, 7, 6)
    with torch.no_grad():
        want, (h_w, c_w) = ref(x)
        for d, reverse in enumerate((False, True)):
            tm = FusedLSTM(6, 9, reverse=reverse)
            p = ti.lstm_params_from_torch(sd, "rnn", 0, reverse=reverse)
            tm.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()})
            hs, (h, c) = tm(x)
            torch.testing.assert_close(hs, want[..., d * 9:(d + 1) * 9],
                                       atol=ATOL, rtol=0)
            torch.testing.assert_close(h, h_w[d], atol=ATOL, rtol=0)
            torch.testing.assert_close(c, c_w[d], atol=ATOL, rtol=0)


def test_fresh_init_follows_flax():
    """``wi`` xavier-uniform over (F, 4H), ``wh`` (H, 4H) with orthonormal
    rows, ``b`` zero; names and shapes those of the flax tree."""
    jm = JaxLSTM(9)
    want = {k: v.shape for k, v in _flat(_np(jm.init(
        jax.random.key(0), jnp.zeros((1, 2, 6))))["params"]).items()}
    tm = FusedLSTM(6, 9, generator=torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == want
    wh = tm.wh.detach().numpy()
    np.testing.assert_allclose(wh @ wh.T, np.eye(9), atol=1e-5)
    assert np.abs(tm.wi.detach().numpy()).max() <= np.sqrt(6 / (6 + 36))
    assert not tm.b.detach().any()


# -------------------------------------------------------- LSTM Seq2SeqRNN --


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, T, C)).astype(np.float32),
            rng.integers(0, NCLS, size=(B, L)).astype(np.int32))


@pytest.fixture(scope="module")
def ref():
    """One flax init of the LSTM Seq2SeqRNN (two encoder and two decoder
    layers) at dropout 0, with running averages off their init values, and
    JAX's eval-mode logits at teacher forcing 0 and 1, the gradients of
    the train-mode loss at teacher forcing 1 and two train steps, at full
    float32."""
    jm = JaxSeq2Seq(**KW, cnn_dropout=0.0, rnn_dropout=0.0)
    x, y = _batch(3)
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    v = jax.jit(lambda k: jm.init({"params": k, "tf": k}, xj, yj, 0.5,
                                  False))(jax.random.key(0))
    ar = jnp.arange(NF, dtype=jnp.float32)
    v = {"params": v["params"],
         "batch_stats": {"TemporalConv_0": {"BatchNorm_0": {
             "mean": 0.05 * ar - 0.1, "var": 1.0 + 0.3 * ar}}}}
    out = {"x": x, "y": y, "variables": _np(v)}
    with jax.default_matmul_precision("highest"):
        apply = jax.jit(lambda v, y, tf: jm.apply(
            v, xj, y, tf, True, rngs={"tf": jax.random.key(3)}),
            static_argnums=2)
        out["logits_tf0"] = np.array(apply(v, None, 0.0))
        out["logits_tf1"] = np.array(apply(v, yj, 1.0))

        def loss(params):
            logits, _ = jm.apply(
                {"params": params, "batch_stats": v["batch_stats"]}, xj, yj,
                1.0, False, rngs={"tf": jax.random.key(0)},
                mutable=["batch_stats"])
            lp = jax.nn.log_softmax(logits.reshape(-1, NCLS))
            return -jnp.take_along_axis(lp, yj.reshape(-1, 1), 1).mean()

        out["grads"] = _np(jax.jit(jax.grad(loss))(v["params"]))
        tx = jloops.make_optimizer(1e-3, 1e-5, 10)
        state = jax_create_state(jm, v, tx)
        step = jax.jit(jax_train_step(jm, tx, teacher_forcing=1.0))
        out["steps"] = []
        for i in range(STEPS):
            state, m = step(state, (xj, yj), jax.random.key(i))
            out["steps"].append((_np(m), _np({"params": state.params,
                                              "batch_stats":
                                                  state.batch_stats})))
    return out


def _loaded(ref):
    tm = Seq2SeqRNN(C, NF, H, NCLS, n_enc_layers=2, n_dec_layers=2,
                    kernel_size=K, cnn_dropout=0.0, rnn_dropout=0.0,
                    cell="lstm", device="cpu")
    v = ref["variables"]
    tm.load_state_dict(seq2seq_params_from_flax(v["params"],
                                                v["batch_stats"]))
    return tm


@pytest.mark.parametrize("teacher_forcing", [0.0, 1.0])
def test_seq2seq_lstm_logits_match_jax(ref, teacher_forcing):
    """Eval-mode logits. At teacher forcing 0 the argmax is fed back: each
    fed-back token's top-2 logit margin must exceed 10x the tolerance."""
    tm = _loaded(ref).eval()
    assert "decoder.rnn.fwd1.b" in tm.state_dict()
    want = ref["logits_tf0" if teacher_forcing == 0 else "logits_tf1"]
    yt = None if teacher_forcing == 0 else torch.from_numpy(ref["y"])
    with torch.no_grad():
        got = tm(torch.from_numpy(ref["x"]), yt, teacher_forcing).numpy()
    assert got.shape == want.shape == (B, L, NCLS)
    np.testing.assert_allclose(got, want, atol=ATOL)
    if teacher_forcing == 0:
        top2 = np.sort(want[:, :-1], axis=-1)[..., -2:]
        assert (top2[..., 1] - top2[..., 0]).min() > 10 * ATOL


def test_seq2seq_lstm_gradients_match_jax(ref):
    """Every gradient of the train-mode loss at teacher forcing 1; the conv
    bias, whose exact gradient is 0 under the BatchNorm, against the conv
    weight's scale (as tests/test_torch_seq2seq.py)."""
    tm = _loaded(ref).train()
    yt = torch.from_numpy(ref["y"])
    logits = tm(torch.from_numpy(ref["x"]), yt, 1.0)
    loss = torch.nn.functional.cross_entropy(logits.reshape(-1, NCLS),
                                             yt.reshape(-1).long())
    names, params = zip(*tm.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, params)))
    want = seq2seq_params_from_flax(ref["grads"], {})
    assert set(want) == set(grads)
    w_scale = float(want["conv.weight"].abs().max())
    for name, w in want.items():
        scale = w_scale if name == "conv.bias" else float(w.abs().max())
        np.testing.assert_allclose(grads[name].numpy(), w.numpy(),
                                   atol=GRAD_RTOL * scale, rtol=0,
                                   err_msg=name)
    assert float(want["encoder.rnn.bwd1.b"].abs().max()) > 0


def test_seq2seq_lstm_two_train_steps_match_jax(ref):
    """Dropout 0, teacher forcing 1, AdamW: the loss (rtol 1e-5) and every
    parameter (atol 2e-6; the running averages 1e-6) after each step, the
    conv bias held as tests/test_torch_seq2seq.py holds it (its gradient is
    rounding noise, which Adam turns into steps of about lr)."""
    lr = 1e-3
    tm = _loaded(ref)
    tx = make_optimizer(lr, 1e-5, 10)
    state = create_train_state(tm, tx)
    step = make_seq2seq_train_step(tm, tx, teacher_forcing=1.0)
    batch = (torch.from_numpy(ref["x"]), torch.from_numpy(ref["y"]))
    for i, (mj, vj) in enumerate(ref["steps"]):
        state, m = step(state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(mj["loss"]),
                                   rtol=1e-5)
        want = seq2seq_params_from_flax(vj["params"], vj["batch_stats"])
        got = tm.state_dict()
        assert set(got) == set(want)
        for name, w in want.items():
            atol = (1e-6 if name.endswith(("norm.mean", "norm.var"))
                    else PARAM_ATOL)
            if name == "conv.bias":
                atol = 2 * lr * (i + 1)
            if name == "conv.norm.mean":
                atol += 0.01 * 2 * lr * i
            np.testing.assert_allclose(got[name].numpy(), w.numpy(),
                                       atol=atol,
                                       err_msg=f"{name} after step {i}")
    assert state.step == STEPS
