"""Port Seq2SeqRNN and its pieces against the JAX package's.

The same numpy inputs (and, for the models, one flax init carried over by
``seq2seq_params_from_flax``) go to both packages. The JAX side runs its
Pallas path, forced on as tests/test_models.py:195-201 does, so the fused
bidirectional ``_bifwd_kernel`` and the ``_fwd_kernel``/``_bwd_kernel``
sweeps run in interpret mode, with JAX products pinned to full float32;
its functions are jitted and the seq2seq results computed once per module,
to keep this file's time down. The port runs on CPU tensors, i.e. through
the plain versions of its kernels. Tolerances are stated at each
comparison.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cross_patient_speech_decoding_tpu.ops.pallas_gru as pg
from cross_patient_speech_decoding_tpu.models import Seq2SeqRNN as JaxSeq2Seq
from cross_patient_speech_decoding_tpu.models.layers import (
    StackedRNN as JaxStackedRNN,
)
from cross_patient_speech_decoding_tpu.models.layers import (
    TemporalConv as JaxTemporalConv,
)
from cross_patient_speech_decoding_tpu.ops import metrics as jmetrics
from cross_patient_speech_decoding_tpu.train import (
    create_train_state as jax_create_state,
)
from cross_patient_speech_decoding_tpu.train import loops as jloops
from cross_patient_speech_decoding_tpu.train.steps import (
    make_seq2seq_eval_step as jax_eval_step,
)
from cross_patient_speech_decoding_tpu.train.steps import (
    make_seq2seq_train_step as jax_train_step,
)
from cross_patient_speech_decoding_tpu_torch.models import (
    Seq2SeqRNN,
    StackedRNN,
    TemporalConv,
    seq2seq_params_from_flax,
)
from cross_patient_speech_decoding_tpu_torch.models.layers import (
    Conv1dF32,
    conv_f32,
)
from cross_patient_speech_decoding_tpu_torch.ops import gru, metrics
from cross_patient_speech_decoding_tpu_torch.train import (
    create_train_state,
    load_checkpoint,
    make_optimizer,
    make_seq2seq_eval_step,
    make_seq2seq_train_step,
    save_checkpoint,
)

torch.set_num_threads(2)

B, T, C, NF, H, K, L, NCLS = 6, 16, 3, 5, 12, 4, 3, 5
KW = dict(n_filters=NF, hidden=H, num_classes=NCLS, kernel_size=K)
BIDIR_NAMES = ("x", "h0_f", "h0_b", "wi_f", "bi_f", "wh_f", "bh_f", "wi_b",
               "bi_b", "wh_b", "bh_b")
STEPS = 2


def _force_pallas(mp):
    """The JAX GRU layers through their Pallas kernels, fused
    bidirectional included, at every size."""
    mp.setattr(pg, "enabled", lambda: True)
    mp.setattr(pg, "MIN_BT", 1)
    mp.setattr(pg, "MIN_SEQ_T", 1)
    mp.setattr(pg, "BIDIR_FUSED", True)


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _flat(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {".".join(p.key for p in path): np.array(v) for path, v in flat}


def _assert_grad_close(got, want, name, scale=None):
    """|got - want| <= 5e-6 x the gradient's largest value (or x ``scale``
    where the exact gradient is 0)."""
    want = np.asarray(want)
    scale = np.abs(want).max() if scale is None else scale
    np.testing.assert_allclose(np.asarray(got), want, atol=5e-6 * scale,
                               rtol=0, err_msg=name)


# ----------------------------------------------------------- bidir op --


def _bidir_case(seed, T_, B_, F_, H_):
    rng = np.random.default_rng(seed)

    def w():
        return [(rng.normal(size=(F_, 3 * H_)) / np.sqrt(F_)),
                rng.normal(size=(3 * H_,)) * 0.1,
                rng.normal(size=(H_, 3 * H_)) / np.sqrt(H_),
                rng.normal(size=(3 * H_,)) * 0.1]

    args = [rng.normal(size=(T_, B_, F_)) * 0.5,
            rng.normal(size=(B_, H_)) * 0.3, rng.normal(size=(B_, H_)) * 0.3,
            *w(), *w()]
    return [a.astype(np.float32) for a in args]


@pytest.mark.parametrize("need_dx", [True, False])
def test_gru_layer_bidir_matches_jax(need_dx):
    """The port's bidirectional op (plain versions on the CPU) against JAX
    ``gru_layer_bidir``, whose forward is the interpret-mode
    ``_bifwd_kernel`` and backward two ``_bwd_kernel`` sweeps, at B=10
    (JAX pads it to 16) and H=33 (JAX pads it to 128 lanes): outputs to
    atol 2e-6, every gradient to 5e-6 x its largest value, with dx and
    without (x as data: JAX input_grad=False; the port's x needs no
    gradient and no dx is formed)."""
    args = _bidir_case(1, 6, 10, 9, 33)
    rng = np.random.default_rng(2)
    dhs = [rng.normal(size=(6, 10, 33)).astype(np.float32) for _ in range(2)]

    @jax.jit
    def ref(args, dhs):
        out, vjp = jax.vjp(
            lambda *a: pg.gru_layer_bidir(*a, input_grad=need_dx), *args)
        return out, vjp(dhs)

    with jax.default_matmul_precision("highest"):
        (hf_j, hb_j), want = ref([jnp.asarray(a) for a in args],
                                 tuple(jnp.asarray(d) for d in dhs))
    ts = [torch.tensor(a, requires_grad=i > 0 or need_dx)
          for i, a in enumerate(args)]
    hf, hb = gru.gru_layer_bidir(*ts)
    np.testing.assert_allclose(hf.detach().numpy(), np.asarray(hf_j),
                               atol=2e-6)
    np.testing.assert_allclose(hb.detach().numpy(), np.asarray(hb_j),
                               atol=2e-6)
    torch.autograd.backward((hf, hb), tuple(torch.from_numpy(d) for d in dhs))
    assert (ts[0].grad is not None) == need_dx
    for name, t, w in zip(BIDIR_NAMES, ts, want):
        if t.grad is not None:
            _assert_grad_close(t.grad.numpy(), w, name)


def test_bidir_backward_asks_for_dx_only_when_x_trains(monkeypatch):
    args = [torch.from_numpy(a) for a in _bidir_case(3, 4, 5, 6, 7)]
    asked = []
    plain = gru.gru_backward_plain

    def spy(*a, need_dx=True, **kw):
        asked.append((a[7], need_dx))  # (reverse, need_dx)
        return plain(*a, need_dx=need_dx, **kw)

    monkeypatch.setattr(gru, "gru_backward_plain", spy)
    gru.reset_launch_counts()
    for x_trains in (False, True):
        ts = [a.clone().requires_grad_(i > 0 or x_trains)
              for i, a in enumerate(args)]
        hf, hb = gru.gru_layer_bidir(*ts)
        (hf.sum() + hb[0].sum()).backward()
    # forward sweep then reversed sweep, each time
    assert asked == [(False, False), (True, False), (False, True),
                     (True, True)]
    assert sum(gru.LAUNCHES.values()) == 0  # CPU tensors: plain versions


def test_stacked_rnn_bidirectional_matches_jax(monkeypatch):
    """2 bidirectional layers (the second reads 2H features) with initial
    states, from one flax init: out (B, T, 2H) and lasts (4, B, H), laid
    out per layer forward then reverse, to atol 2e-6."""
    _force_pallas(monkeypatch)
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(6, 12, 10)) * 0.5).astype(np.float32)
    h0 = (rng.normal(size=(4, 6, 16)) * 0.3).astype(np.float32)
    jm = JaxStackedRNN(hidden=16, n_layers=2, bidirectional=True)
    params = jm.init(jax.random.key(0), jnp.asarray(x))
    with jax.default_matmul_precision("highest"):
        out_j, lasts_j = jax.jit(jm.apply)(params, jnp.asarray(x),
                                           jnp.asarray(h0))
    tm = StackedRNN(10, 16, n_layers=2, bidirectional=True)
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in
                        _flat(params["params"]).items()})
    with torch.no_grad():
        out, lasts = tm(torch.from_numpy(x), torch.from_numpy(h0))
    assert out.shape == (6, 12, 32) and lasts.shape == (4, 6, 16)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=2e-6)
    np.testing.assert_allclose(lasts.numpy(), np.asarray(lasts_j), atol=2e-6)
    torch.testing.assert_close(lasts[2], out[:, -1, :16], atol=0, rtol=0)
    torch.testing.assert_close(lasts[3], out[:, 0, 16:], atol=0, rtol=0)


# ------------------------------------------------------- temporal conv --


@pytest.mark.parametrize("stride", [1, 2])
def test_temporal_conv_matches_jax_train_and_eval(stride):
    """Train mode (batch statistics, running averages moved once) and then
    eval mode (those running averages) against flax, at dropout 0:
    outputs to atol 1e-5, running mean and var to 1e-6."""
    rng = np.random.default_rng(6)
    x = (rng.normal(size=(B, T, C)) * 2 + 0.5).astype(np.float32)
    jm = JaxTemporalConv(NF, K, stride, dropout=0.0)
    v = jm.init(jax.random.key(1), jnp.asarray(x))
    # scale and bias off their init values so that they matter
    params = jax.tree_util.tree_map(
        lambda a: a + 0.1 * jnp.arange(a.size, dtype=a.dtype).reshape(
            a.shape) / a.size, v["params"])
    v = {"params": params, "batch_stats": v["batch_stats"]}
    with jax.default_matmul_precision("highest"):
        y_train, upd = jm.apply(v, jnp.asarray(x), False,
                                mutable=["batch_stats"])
        v2 = {"params": params, "batch_stats": upd["batch_stats"]}
        y_eval = jm.apply(v2, jnp.asarray(x) * 0.5, True)
    tm = TemporalConv(C, NF, K, stride, dropout=0.0)
    p = _flat(params)
    with torch.no_grad():
        tm.weight.copy_(torch.from_numpy(
            p["Conv_0.kernel"].transpose(2, 1, 0).copy()))
        tm.bias.copy_(torch.from_numpy(p["Conv_0.bias"]))
        tm.norm.scale.copy_(torch.from_numpy(p["BatchNorm_0.scale"]))
        tm.norm.bias.copy_(torch.from_numpy(p["BatchNorm_0.bias"]))
        got_train = tm(torch.from_numpy(x))
        bs = _flat(upd["batch_stats"])
        np.testing.assert_allclose(tm.norm.mean.numpy(),
                                   bs["BatchNorm_0.mean"], atol=1e-6)
        np.testing.assert_allclose(tm.norm.var.numpy(),
                                   bs["BatchNorm_0.var"], atol=1e-6)
        running = tm.norm.mean.clone()
        tm.eval()
        got_eval = tm(torch.from_numpy(x) * 0.5)
    T_out = (T - K) // stride + 1
    assert got_train.shape == got_eval.shape == (B, T_out, NF)
    assert got_eval.is_contiguous()  # the encoder's kernel reads rows
    np.testing.assert_allclose(got_train.numpy(), np.asarray(y_train),
                               atol=1e-5)
    np.testing.assert_allclose(got_eval.numpy(), np.asarray(y_eval),
                               atol=1e-5)
    assert torch.equal(tm.norm.mean, running)  # eval mode leaves it alone


def test_conv_gradients_and_precision_setting():
    """Conv1dF32 has F.conv1d's gradients; conv_f32 pins cuDNN's conv
    setting to "ieee" inside the block and gives back each caller
    setting after it, without making the legacy getter raise."""
    rng = np.random.default_rng(7)
    x = torch.tensor(rng.normal(size=(3, 4, 11)).astype(np.float32),
                     requires_grad=True)
    w = torch.tensor(rng.normal(size=(5, 4, 3)).astype(np.float32),
                     requires_grad=True)
    b = torch.tensor(rng.normal(size=(5,)).astype(np.float32),
                     requires_grad=True)
    g = torch.from_numpy(rng.normal(size=(3, 5, 5)).astype(np.float32))
    y = Conv1dF32.apply(x, w, b, 2)
    got = torch.autograd.grad(y, (x, w, b), g)
    y2 = torch.nn.functional.conv1d(x, w, b, stride=2)
    want = torch.autograd.grad(y2, (x, w, b), g)
    torch.testing.assert_close(y, y2, atol=0, rtol=0)
    for a, c in zip(got, want):
        torch.testing.assert_close(a, c, atol=1e-6, rtol=0)
    conv = torch.backends.cudnn.conv
    old = conv.fp32_precision
    try:
        for caller in ("tf32", "ieee", "none"):
            conv.fp32_precision = caller
            with conv_f32():
                assert conv.fp32_precision == "ieee"
            assert conv.fp32_precision == caller
        torch.backends.cudnn.allow_tf32 = True  # a legacy caller
        with conv_f32():
            pass
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = True
        conv.fp32_precision = old


# ------------------------------------------------------------- seq2seq --


def _batch(n=B, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, T, C)).astype(np.float32)
    y = rng.integers(0, NCLS, size=(n, L)).astype(np.int32)
    return x, y


def _port_model(dropout=0.0, seed=0):
    return Seq2SeqRNN(C, NF, H, NCLS, kernel_size=K, cnn_dropout=dropout,
                      rnn_dropout=dropout, seed=seed, device="cpu")


@pytest.fixture(scope="module")
def ref():
    """One flax init of Seq2SeqRNN at dropout 0, with running averages set
    off their init values, and every JAX result the seq2seq tests compare
    with, on the batch ``_batch(seed=3)``: eval-mode logits at teacher
    forcing 0 and 1, the eval step's metrics, the gradients of the
    train-mode loss at teacher forcing 1, and two JAX train steps at
    teacher forcing 1 (the coins cannot matter), all through the
    interpret-mode Pallas kernels."""
    jm = JaxSeq2Seq(**KW, cnn_dropout=0.0, rnn_dropout=0.0)
    x, y = _batch(seed=3)
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    v = jax.jit(lambda k: jm.init({"params": k, "tf": k}, xj, yj, 0.5,
                                  False))(jax.random.key(0))
    ar = jnp.arange(NF, dtype=jnp.float32)
    v = {"params": v["params"],
         "batch_stats": {"TemporalConv_0": {"BatchNorm_0": {
             "mean": 0.05 * ar - 0.1, "var": 1.0 + 0.3 * ar}}}}
    out = {"jm": jm, "x": x, "y": y, "variables": _np(v)}
    with pytest.MonkeyPatch.context() as mp, \
            jax.default_matmul_precision("highest"):
        _force_pallas(mp)
        apply = jax.jit(lambda v, y, tf: jm.apply(
            v, xj, y, tf, True, rngs={"tf": jax.random.key(3)}),
            static_argnums=2)
        out["logits_tf0"] = np.array(apply(v, None, 0.0))
        out["logits_tf1"] = np.array(apply(v, yj, 1.0))
        tx = jloops.make_optimizer(1e-3, 1e-5, 10)
        state = jax_create_state(jm, v, tx)
        out["eval"] = _np(jax.jit(jax_eval_step(jm))(state, (xj, yj)))

        def loss(params):
            logits, _ = jm.apply(
                {"params": params, "batch_stats": v["batch_stats"]}, xj, yj,
                1.0, False, rngs={"tf": jax.random.key(0)},
                mutable=["batch_stats"])
            lp = jax.nn.log_softmax(logits.reshape(-1, NCLS))
            return -jnp.take_along_axis(lp, yj.reshape(-1, 1), 1).mean()

        out["grads"] = _flat(jax.jit(jax.grad(loss))(v["params"]))
        step = jax.jit(jax_train_step(jm, tx, teacher_forcing=1.0))
        out["steps"] = []
        for i in range(STEPS):
            state, m = step(state, (xj, yj), jax.random.key(i))
            out["steps"].append((_np(m), _np({"params": state.params,
                                              "batch_stats":
                                                  state.batch_stats})))
    return out


def _loaded(ref, dropout=0.0):
    tm = _port_model(dropout)
    v = ref["variables"]
    tm.load_state_dict(seq2seq_params_from_flax(v["params"],
                                                v["batch_stats"]))
    return tm


@pytest.mark.parametrize("teacher_forcing", [0.0, 1.0])
def test_seq2seq_logits_match_jax(ref, teacher_forcing):
    """Eval-mode logits from one flax init, atol 1e-5. At teacher forcing 0
    the argmax is fed back: each fed-back token's top-2 logit margin must
    exceed 10x the tolerance, so that no argmax can flip within it. At 1
    every step is teacher-forced whatever the coins."""
    tm = _loaded(ref).eval()
    want = ref["logits_tf0" if teacher_forcing == 0 else "logits_tf1"]
    yt = None if teacher_forcing == 0 else torch.from_numpy(ref["y"])
    with torch.no_grad():
        got = tm(torch.from_numpy(ref["x"]), yt, teacher_forcing).numpy()
    assert got.shape == want.shape == (B, L, NCLS)
    np.testing.assert_allclose(got, want, atol=1e-5)
    if teacher_forcing == 0:
        top2 = np.sort(want[:, :-1], axis=-1)[..., -2:]
        assert (top2[..., 1] - top2[..., 0]).min() > 1e-4


def test_argmax_feedback_takes_the_first_index_on_ties():
    tm = _port_model().eval()
    with torch.no_grad():
        tm.decoder.head.kernel.zero_()
        tm.decoder.head.bias.copy_(torch.tensor([0.0, 2.0, 2.0, 1.0, 2.0]))
    fed = []
    dec = tm.decoder.forward
    tm.decoder.forward = lambda tok, *a: (fed.append(tok.clone()),
                                          dec(tok, *a))[1]
    with torch.no_grad():
        tm(torch.from_numpy(_batch()[0]), None, 0.0)
    assert [t.tolist() for t in fed] == [[NCLS] * B, [1] * B, [1] * B]


def test_eval_step_matches_jax_and_keeps_the_mode(ref):
    """Loss (rtol 1e-5) and accuracy (exact) of the eval step; the step
    runs in eval mode whatever mode the model is in, and leaves it so,
    with the running averages untouched."""
    tm = _loaded(ref)
    step = make_seq2seq_eval_step(tm)
    batch = (torch.from_numpy(ref["x"]), torch.from_numpy(ref["y"]))
    for training in (True, False):
        tm.train(training)
        m = step(batch)
        assert tm.training is training
        np.testing.assert_allclose(float(m["loss"]),
                                   float(ref["eval"]["loss"]), rtol=1e-5)
        assert float(m["acc"]) == pytest.approx(float(ref["eval"]["acc"]),
                                                abs=1e-7)
    bs = ref["variables"]["batch_stats"]["TemporalConv_0"]["BatchNorm_0"]
    assert torch.equal(tm.conv.norm.mean, torch.from_numpy(bs["mean"]))


def test_loss_gradients_match_jax(ref):
    """Every gradient of the train-mode loss (batch statistics, teacher
    forcing 1), to 5e-6 x its largest value. The conv bias's exact
    gradient is 0 (the BatchNorm removes any per-filter shift), so both
    sides hold rounding noise there: it is held to 5e-6 x the conv
    weight's largest gradient."""
    tm = _loaded(ref).train()
    logits = tm(torch.from_numpy(ref["x"]), torch.from_numpy(ref["y"]), 1.0)
    loss = torch.nn.functional.cross_entropy(
        logits.reshape(-1, NCLS), torch.from_numpy(ref["y"]).reshape(-1).long())
    names, params = zip(*tm.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, params)))
    want = seq2seq_params_from_flax(ref["grads"], {})
    assert set(want) == set(grads)
    w_scale = float(want["conv.weight"].abs().max())
    for name, w in want.items():
        _assert_grad_close(grads[name].numpy(), w.numpy(), name,
                           w_scale if name == "conv.bias" else None)


def test_two_train_steps_match_jax(ref):
    """Dropout 0, teacher forcing 1, AdamW, from one flax init: after each
    of two steps, the loss (rtol 1e-5), the accuracy (exact), every
    parameter (atol 2e-6) and the BatchNorm's running averages (atol
    1e-6) against the JAX package's train step. The conv bias is the
    exception: its gradient is rounding noise on both sides (see
    test_loss_gradients_match_jax), which Adam normalises to steps of
    about lr, so it is held to 2 lr per step taken; it changes no output,
    the BatchNorm removes it, but the running mean takes 0.01 of it from
    the second step on."""
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
        assert float(m["acc"]) == pytest.approx(float(mj["acc"]), abs=1e-7)
        want = seq2seq_params_from_flax(vj["params"], vj["batch_stats"])
        got = tm.state_dict()
        assert set(got) == set(want)
        for name, w in want.items():
            atol = 1e-6 if name.endswith(("norm.mean", "norm.var")) else 2e-6
            if name == "conv.bias":
                atol = 2 * lr * (i + 1)
            if name == "conv.norm.mean":  # moved by 0.01 x that bias
                atol += 0.01 * 2 * lr * i
            np.testing.assert_allclose(got[name].numpy(), w.numpy(),
                                       atol=atol,
                                       err_msg=f"{name} after step {i}")
    assert state.step == STEPS


def test_params_from_flax_layout_and_fresh_init_scales(ref):
    """The converted state dict has the port model's names and shapes (the
    conv kernel transposed to (n_filters, C, K)); a fresh port model
    draws flax's initialisers from its seed."""
    v = ref["variables"]
    sd = seq2seq_params_from_flax({"params": v["params"]},
                                  {"batch_stats": v["batch_stats"]})
    fresh = _port_model(seed=3)
    want = {k: tuple(t.shape) for k, t in fresh.state_dict().items()}
    assert {k: tuple(t.shape) for k, t in sd.items()} == want
    kern = v["params"]["TemporalConv_0"]["Conv_0"]["kernel"]  # (K, C, NF)
    np.testing.assert_array_equal(sd["conv.weight"].numpy()[2, 1],
                                  kern[:, 1, 2])
    fs = fresh.state_dict()
    assert torch.equal(fs["conv.norm.var"], torch.ones(NF))
    assert torch.equal(fs["conv.norm.mean"], torch.zeros(NF))
    lim = 2 * np.sqrt(1 / (C * K)) / 0.87962566103423978
    assert 0 < float(fs["conv.weight"].abs().max()) <= lim
    emb = fs["decoder.embed.embedding"]
    assert emb.shape == (NCLS + 1, H) and float(emb.std()) < 2 / np.sqrt(H)
    wh = fs["encoder.rnn.bwd0.wh"].numpy()
    np.testing.assert_allclose(wh @ wh.T, np.eye(H), atol=1e-5)
    again = _port_model(seed=3).state_dict()
    assert all(torch.equal(fs[k], again[k]) for k in fs)


def test_checkpoint_round_trip_carries_batchnorm_buffers(tmp_path):
    """2 steps at dropout 0.3 and teacher forcing 0.5, save, load into a
    fresh state of another seed: the running averages come back, and one
    more step equals 3 steps straight, bitwise on the CPU."""
    bt = tuple(torch.from_numpy(a) for a in _batch())
    tx = make_optimizer(1e-3, 1e-5, 10)

    def run(tm, n, gen, state=None):
        state = state or create_train_state(tm, tx)
        step = make_seq2seq_train_step(tm, tx)
        for _ in range(n):
            state, m = step(state, bt, gen)
        return state, m

    gen = torch.Generator().manual_seed(3)
    straight, m3 = run(_port_model(0.3), 3, gen)
    gen = torch.Generator().manual_seed(3)
    state, _ = run(_port_model(0.3), 2, gen)
    path = tmp_path / "ck.pt"
    save_checkpoint(str(path), state)
    fresh = create_train_state(_port_model(0.3, seed=9), tx)
    loaded = load_checkpoint(str(path), fresh)
    norm = loaded.model.conv.norm
    assert torch.equal(norm.mean, state.model.conv.norm.mean)
    assert torch.equal(norm.var, state.model.conv.norm.var)
    assert not torch.equal(norm.var, torch.ones(NF))
    resumed, m1 = run(loaded.model, 1, gen, loaded)
    assert torch.equal(m1["loss"], m3["loss"])
    a, b = straight.model.state_dict(), resumed.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_fit_takes_the_seq2seq_steps():
    """``fit`` runs the seq2seq steps as they are: mini-batches, a
    history per epoch of the eval step's metrics, the best state a copy
    at the best monitored accuracy."""
    from cross_patient_speech_decoding_tpu_torch.train import fit

    tm = _port_model(dropout=0.3)
    tx = make_optimizer(3e-2, 1e-5, 10)
    train = tuple(torch.from_numpy(a) for a in _batch(n=8, seed=6))
    val = tuple(torch.from_numpy(a) for a in _batch(n=6, seed=7))
    res = fit(create_train_state(tm, tx), make_seq2seq_train_step(tm, tx),
              make_seq2seq_eval_step(tm), train, val, epochs=3,
              generator=torch.Generator().manual_seed(0), monitor="acc",
              mode="max", batch_size=4, seed=1)
    assert [h["epoch"] for h in res.history] == [0, 1, 2]
    assert all(set(h) == {"epoch", "loss", "acc"} for h in res.history)
    best = max(h["acc"] for h in res.history)
    assert res.best_metric == pytest.approx(best)
    assert res.best_state.step == 2 * (res.best_epoch + 1)
    assert res.best_state.model is not tm


def test_dropout_and_teacher_forcing_coins_by_statistics():
    """The conv's dropout keeps 1 - p of the entries, scaled by 1/(1 - p);
    teacher forcing takes one coin per step for the whole batch and feeds
    the labels at about the ratio's rate; the same generator seed repeats
    a forward bitwise; eval mode draws nothing."""
    tm = _port_model(dropout=0.3).train()
    x = torch.from_numpy(_batch(n=40)[0])
    with torch.no_grad():
        pre = tm.conv.norm(torch.nn.functional.conv1d(
            x.transpose(1, 2), tm.conv.weight, tm.conv.bias).transpose(1, 2))
        post = tm.conv(x, torch.Generator().manual_seed(0))
    kept = post != 0
    assert abs(kept.float().mean().item() - 0.7 * (pre > 0).float().mean()
               .item()) < 0.02
    torch.testing.assert_close(post[kept], torch.relu(pre)[kept] / 0.7)

    fed = []
    dec = tm.decoder.forward
    tm.decoder.forward = lambda tok, *a: (fed.append(tok.clone()),
                                          dec(tok, *a))[1]
    x4 = torch.from_numpy(_batch(n=4, seed=5)[0])
    y4 = (torch.arange(4)[:, None] + torch.arange(L)) % NCLS
    gen = torch.Generator().manual_seed(1)
    forced = []
    with torch.no_grad():
        for _ in range(150):
            fed.clear()
            logits = tm(x4, y4, 0.5, gen)
            for i in range(1, L):
                teacher = torch.equal(fed[i], y4[:, i - 1])
                pred = torch.equal(fed[i], logits[:, i - 1].argmax(-1))
                assert teacher or pred  # one coin for the whole batch
                if teacher != pred:
                    forced.append(teacher)
    assert len(forced) > 100 and abs(np.mean(forced) - 0.5) < 0.1
    g1, g2 = (torch.Generator().manual_seed(7) for _ in range(2))
    with torch.no_grad():
        assert torch.equal(tm(x4, y4, 0.5, g1), tm(x4, y4, 0.5, g2))
        tm.eval()
        before = gen.get_state()
        tm(x4, y4, 0.0, gen)
        assert torch.equal(gen.get_state(), before)


@pytest.mark.parametrize("masked", [False, True])
def test_confusion_matrix_and_cmat_acc_match_jax(masked):
    rng = np.random.default_rng(8)
    yt = rng.integers(0, 4, 50).astype(np.int32)
    yp = np.where(rng.random(50) < 0.6, yt, rng.integers(0, 4, 50)).astype(
        np.int32)
    mask = (rng.random(50) < 0.7).astype(np.float32) if masked else None
    mj = None if mask is None else jnp.asarray(mask)
    mt = None if mask is None else torch.from_numpy(mask)
    want = np.asarray(jmetrics.confusion_matrix(jnp.asarray(yt),
                                                jnp.asarray(yp), 4, mj))
    got = metrics.confusion_matrix(torch.from_numpy(yt), torch.from_numpy(yp),
                                   4, mt)
    np.testing.assert_array_equal(got.numpy(), want)
    acc_j = float(jmetrics.cmat_acc(jnp.asarray(yt), jnp.asarray(yp), 4, mj))
    acc = float(metrics.cmat_acc(torch.from_numpy(yt), torch.from_numpy(yp),
                                 4, mt))
    assert acc == pytest.approx(acc_j, abs=1e-7)


def test_train_step_metrics_are_json_ready():
    tm = _port_model()
    tx = make_optimizer(1e-3, 1e-5, 10)
    state, m = make_seq2seq_train_step(tm, tx)(
        create_train_state(tm, tx),
        tuple(torch.from_numpy(a) for a in _batch()),
        torch.Generator().manual_seed(0))
    rec = json.loads(json.dumps({k: float(v) for k, v in m.items()}))
    assert set(rec) == {"loss", "acc"} and 0.0 <= rec["acc"] <= 1.0
    assert state.step == 1 and np.isfinite(rec["loss"])
