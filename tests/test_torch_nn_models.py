"""The port's classifier families (TCN, transformer, CNN-transformer,
conv-GRU, SimpleGRU), their layers and the classifier steps against the
JAX package's.

One flax init per family (dropout 0, running averages set off their init
values) is carried over by ``nn_classifier_params_from_flax``; the same
numpy batch goes to both packages. The JAX side runs its GRU layers
through the Pallas kernels in interpret mode, forced on as
tests/test_models.py:195-201 does, with its products pinned to full
float32, and is jitted and computed once per module (the ``ref``
fixture). The port runs on CPU tensors, i.e. through its kernels' plain
versions. Tolerances are stated at each comparison. Dropout streams
cannot be reproduced across the packages, so the masks are held by
statistics.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cross_patient_speech_decoding_tpu.models as jmodels
import cross_patient_speech_decoding_tpu.ops.pallas_gru as pg
from cross_patient_speech_decoding_tpu.models import layers as jlayers
from cross_patient_speech_decoding_tpu.train import (
    create_train_state as jax_create_state,
)
from cross_patient_speech_decoding_tpu.train import loops as jloops
from cross_patient_speech_decoding_tpu.train.steps import (
    make_classifier_eval_step as jax_eval_step,
)
from cross_patient_speech_decoding_tpu.train.steps import (
    make_classifier_train_step as jax_train_step,
)
from cross_patient_speech_decoding_tpu_torch import models
from cross_patient_speech_decoding_tpu_torch.models import (
    layers,
    nn_classifier_params_from_flax,
    tcn_transformer,
)
from cross_patient_speech_decoding_tpu_torch.ops import gru
from cross_patient_speech_decoding_tpu_torch.train import (
    create_train_state,
    make_classifier_eval_step,
    make_classifier_train_step,
    make_optimizer,
)

torch.set_num_threads(2)

B, T, C, NF, H, K, NCLS = 6, 16, 3, 8, 12, 4, 5
DM, HEADS, DFF, NL = 8, 2, 16, 2
LR, STEPS = 1e-3, 2
LOGITS_ATOL = 1e-5
GRAD_RTOL = 5e-6  # x the gradient's largest value
PARAM_ATOL = 2e-6  # after each train step
STATS_ATOL = 1e-6  # running averages

FAMILIES = ("tcn", "transformer", "cnn_transformer", "conv_rnn", "simple_gru")


def _jax_model(family):
    if family == "tcn":
        return jmodels.TCNClassifier(n_filters=NF, num_classes=NCLS,
                                     kernel_size=K, dropout=0.0,
                                     fc_dims=(6,))
    if family == "transformer":
        return jmodels.TransformerClassifier(
            d_model=DM, num_classes=NCLS, n_heads=HEADS, n_layers=NL,
            dim_ff=DFF, dropout=0.0)
    if family == "cnn_transformer":
        return jmodels.CNNTransformer(
            n_filters=NF, num_classes=NCLS, kernel_size=K, n_heads=HEADS,
            n_layers=NL, dim_ff=DFF, cnn_dropout=0.0, dropout=0.0)
    if family == "conv_rnn":
        return jmodels.TemporalConvRNN(
            n_filters=NF, hidden=H, num_classes=NCLS, kernel_size=K,
            n_layers=NL, cnn_dropout=0.0, rnn_dropout=0.0, fc_dims=(6,))
    return jmodels.SimpleGRU(hidden=H, num_classes=NCLS, n_layers=NL,
                             dropout=0.0)


def _port_model(family, dropout=0.0, seed=0):
    kw = dict(num_classes=NCLS, seed=seed, device="cpu")
    if family == "tcn":
        return models.TCNClassifier(C, NF, kernel_size=K, dropout=dropout,
                                    fc_dims=(6,), **kw)
    if family == "transformer":
        return models.TransformerClassifier(
            C, DM, n_heads=HEADS, n_layers=NL, dim_ff=DFF, dropout=dropout,
            **kw)
    if family == "cnn_transformer":
        return models.CNNTransformer(
            C, NF, kernel_size=K, n_heads=HEADS, n_layers=NL, dim_ff=DFF,
            cnn_dropout=dropout, dropout=dropout, **kw)
    if family == "conv_rnn":
        return models.TemporalConvRNN(
            C, NF, H, kernel_size=K, n_layers=NL, cnn_dropout=dropout,
            rnn_dropout=dropout, fc_dims=(6,), **kw)
    return models.SimpleGRU(C, H, n_layers=NL, dropout=dropout, **kw)


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _batch(n=B, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, T, C)) * 1.5 + 0.3).astype(np.float32)
    y = rng.integers(0, NCLS, size=n).astype(np.int32)
    return x, y


def _tx():
    return dict(lr=LR, weight_decay=1e-5, decay_steps=10, end_factor=0.01,
                clip=0.5)


def _reference(family):
    """Every JAX result the family's tests compare with, on
    ``_batch(seed=3)``: eval and train-mode logits (and the train mode's
    running averages), the gradients of the train-mode loss, two train
    steps and the eval step, through the interpret-mode Pallas GRU."""
    jm = _jax_model(family)
    x, y = _batch(seed=3)
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    v = dict(jm.init(jax.random.key(0), xj))
    if "batch_stats" in v:
        ar = jnp.arange(NF, dtype=jnp.float32)
        v["batch_stats"] = {"TemporalConv_0": {"BatchNorm_0": {
            "mean": 0.05 * ar - 0.1, "var": 1.0 + 0.3 * ar}}}
    bs = v.get("batch_stats", {})
    out = {"x": x, "y": y, "variables": _np(v)}
    key = jax.random.key(5)

    def train_logits(params):
        variables = {"params": params, **({"batch_stats": bs} if bs else {})}
        logits, upd = jm.apply(variables, xj, False, mutable=["batch_stats"],
                               rngs={"dropout": key})
        return logits, upd.get("batch_stats", {})

    def loss(params):
        logits, _ = train_logits(params)
        lp = jax.nn.log_softmax(logits)
        return -jnp.take_along_axis(lp, yj[:, None], 1).mean()

    @jax.jit
    def forward(v):
        return (jm.apply(v, xj, True), train_logits(v["params"]),
                jax.grad(loss)(v["params"]))

    with jax.default_matmul_precision("highest"):
        (out["logits_eval"], (out["logits_train"], out["stats_train"]),
         out["grads"]) = _np(forward(v))
        tx = jloops.make_optimizer(**_tx())
        state = jax_create_state(jm, v, tx)
        out["eval"] = _np(jax.jit(jax_eval_step(jm))(state, (xj, yj)))
        step = jax.jit(jax_train_step(jm, tx))
        out["steps"] = []
        for i in range(STEPS):
            state, m = step(state, (xj, yj), jax.random.key(i))
            out["steps"].append((_np(m), _np(state.params),
                                 _np(state.batch_stats)))
    return out


@pytest.fixture(scope="module")
def ref():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pg, "enabled", lambda: True)
        mp.setattr(pg, "MIN_BT", 1)
        mp.setattr(pg, "MIN_SEQ_T", 1)
        return {f: _reference(f) for f in FAMILIES}


def _loaded(r, family):
    tm = _port_model(family)
    v = r["variables"]
    tm.load_state_dict(nn_classifier_params_from_flax(
        v["params"], v.get("batch_stats", {})))
    return tm


def _exact_zero_grads(family):
    """Parameters whose exact gradient is 0, each with the parameter whose
    largest gradient scales its rounding noise: the conv bias (the
    BatchNorm removes any per-filter shift) and the attention's key bias
    (it adds one constant to a query's scores, which the softmax
    removes)."""
    out = {}
    if family in ("tcn", "cnn_transformer", "conv_rnn"):
        out["conv.bias"] = "conv.weight"
    if family in ("transformer", "cnn_transformer"):
        for i in range(NL):
            out[f"blocks.{i}.attn.key.bias"] = f"blocks.{i}.attn.key.kernel"
    return out


@pytest.mark.parametrize("family", FAMILIES)
def test_logits_match_jax(ref, family):
    """Eval-mode logits (running averages) and train-mode logits at
    dropout 0 (batch statistics, running averages moved once) from one
    flax init: logits to atol 1e-5, running averages to 1e-6."""
    r = ref[family]
    tm = _loaded(r, family).eval()
    x = torch.from_numpy(r["x"])
    with torch.no_grad():
        got = tm(x)
        assert got.shape == (B, NCLS)
        np.testing.assert_allclose(got.numpy(), r["logits_eval"],
                                   atol=LOGITS_ATOL)
        tm.train()
        got = tm(x, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(got.numpy(), r["logits_train"],
                               atol=LOGITS_ATOL)
    want = nn_classifier_params_from_flax({}, r["stats_train"])
    assert set(want) == {k for k in tm.state_dict() if k.endswith(
        ("norm.mean", "norm.var"))}
    for name, w in want.items():
        np.testing.assert_allclose(tm.state_dict()[name].numpy(), w.numpy(),
                                   atol=STATS_ATOL, err_msg=name)


@pytest.mark.parametrize("family", FAMILIES)
def test_loss_gradients_match_jax(ref, family):
    """Every gradient of the train-mode loss to 5e-6 x its largest value;
    a gradient that is 0 in exact arithmetic (:func:`_exact_zero_grads`)
    holds rounding noise on both sides and is held to 5e-6 x the largest
    gradient of its partner."""
    r = ref[family]
    tm = _loaded(r, family).train()
    loss = torch.nn.functional.cross_entropy(
        tm(torch.from_numpy(r["x"])), torch.from_numpy(r["y"]).long())
    names, params = zip(*tm.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, params)))
    want = nn_classifier_params_from_flax(r["grads"], {})
    assert set(want) == set(grads)
    zeros = _exact_zero_grads(family)
    for name, w in want.items():
        scale = float(want[zeros[name]].abs().max() if name in zeros
                      else w.abs().max())
        np.testing.assert_allclose(grads[name].numpy(), w.numpy(),
                                   atol=GRAD_RTOL * scale, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("family", FAMILIES)
def test_two_train_steps_match_jax(ref, family):
    """Dropout 0, AdamW with clipping at 0.5 and the linear decay, from one
    flax init: after each of two steps the loss (rtol 1e-5), the accuracy
    (exact), every parameter (atol 2e-6) and the running averages (1e-6)
    against the JAX package's classifier step. A parameter whose exact
    gradient is 0 (:func:`_exact_zero_grads`) moves by Adam-normalised
    rounding noise of about lr a step on each side: it is held to 2 lr per
    step taken; it changes no output, but the running mean takes 0.01 of
    the conv bias from the second step on."""
    r = ref[family]
    tm = _loaded(r, family)
    tx = make_optimizer(**_tx())
    state = create_train_state(tm, tx)
    step = make_classifier_train_step(tm, tx)
    batch = (torch.from_numpy(r["x"]), torch.from_numpy(r["y"]))
    zeros = _exact_zero_grads(family)
    for i, (mj, pj, bj) in enumerate(r["steps"]):
        state, m = step(state, batch, torch.Generator().manual_seed(i))
        np.testing.assert_allclose(float(m["loss"]), float(mj["loss"]),
                                   rtol=1e-5)
        assert float(m["acc"]) == pytest.approx(float(mj["acc"]), abs=1e-7)
        want = nn_classifier_params_from_flax(pj, bj)
        got = tm.state_dict()
        assert set(got) == set(want)
        for name, w in want.items():
            atol = (STATS_ATOL if name.endswith(("norm.mean", "norm.var"))
                    else PARAM_ATOL)
            if name in zeros:
                atol = 2 * LR * (i + 1)
            if name == "conv.norm.mean":
                atol += 0.01 * 2 * LR * i
            np.testing.assert_allclose(got[name].numpy(), w.numpy(),
                                       atol=atol,
                                       err_msg=f"{name} after step {i}")
    assert state.step == STEPS


@pytest.mark.parametrize("family", FAMILIES)
def test_eval_step_matches_jax_and_keeps_the_mode(ref, family):
    """Loss (rtol 1e-5) and accuracy (exact) of the eval step, in eval mode
    whatever mode the model is in, which it is left in; the running
    averages stay."""
    r = ref[family]
    tm = _loaded(r, family)
    step = make_classifier_eval_step(tm)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    batch = (torch.from_numpy(r["x"]), torch.from_numpy(r["y"]))
    for training in (True, False):
        tm.train(training)
        m = step(batch)
        assert tm.training is training
        np.testing.assert_allclose(float(m["loss"]),
                                   float(r["eval"]["loss"]), rtol=1e-5)
        assert float(m["acc"]) == pytest.approx(float(r["eval"]["acc"]),
                                                abs=1e-7)
    assert all(torch.equal(before[k], v) for k, v in tm.state_dict().items())


@pytest.mark.parametrize("family", FAMILIES)
def test_params_from_flax_layout_and_fresh_init(ref, family):
    """The converted state dict has the port model's names and shapes (the
    attention's kernels in flax's (D, heads, head_dim) layout); a fresh
    port model draws flax's initialisers from its seed, the same weights
    for the same seed."""
    v = ref[family]["variables"]
    sd = nn_classifier_params_from_flax({"params": v["params"]},
                                        {"batch_stats":
                                         v.get("batch_stats", {})})
    fresh = _port_model(family, seed=3)
    fs = fresh.state_dict()
    assert {k: tuple(t.shape) for k, t in sd.items()} == {
        k: tuple(t.shape) for k, t in fs.items()}
    if family in ("transformer", "cnn_transformer"):
        D = DM if family == "transformer" else NF
        assert fs["blocks.0.attn.query.kernel"].shape == (D, HEADS,
                                                          D // HEADS)
        assert fs["blocks.1.attn.out.kernel"].shape == (HEADS, D // HEADS, D)
        assert torch.equal(fs["blocks.0.norm1.scale"], torch.ones(D))
        # lecun-normal over the flat fan-in D, truncated at 2 std
        lim = 2 * math.sqrt(1 / D) / layers.TRUNC_STD
        assert 0 < float(fs["blocks.0.attn.value.kernel"].abs().max()) <= lim
        assert not fs["blocks.0.attn.out.bias"].any()
    if "conv.weight" in fs:
        kern = v["params"]["TemporalConv_0"]["Conv_0"]["kernel"]
        np.testing.assert_array_equal(sd["conv.weight"].numpy()[2, 1],
                                      kern[:, 1, 2])
    again = _port_model(family, seed=3).state_dict()
    assert all(torch.equal(fs[k], again[k]) for k in fs)


@pytest.mark.parametrize("d_model", [7, 8])
def test_positional_encoding_matches_jax(d_model):
    """pe at odd and even widths (an odd width's cos lane has one column
    fewer): over the first 300 positions (the models here see T <= 200)
    to atol 2e-6, over all 5000 to atol 1e-5. Both packages compute in
    float32, and their exp of a frequency may differ by an ulp, which at
    position p moves the argument by ~p ulps (3.8e-6 at d_model 7)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 300, d_model)).astype(np.float32)
    jm = jlayers.PositionalEncoding(d_model)
    want = np.asarray(jm.apply({}, jnp.asarray(x)))
    pe = layers.PositionalEncoding(d_model)
    got = pe(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6)
    full = np.asarray(jm.apply({}, jnp.zeros((1, 5000, d_model))))[0]
    np.testing.assert_allclose(pe.pe.numpy(), full, atol=1e-5)
    assert "pe" not in pe.state_dict()


def test_schedules_match_jax():
    """Both schedules at steps before, at and after their knees, to 1e-6
    of the value or of lr, whichever is larger (JAX evaluates them in
    float32, the port in float64: near step = max_iters, 1 + cos keeps
    few of float32's digits)."""
    for step in (0, 1, 5, 10, 17, 40, 99, 100, 150):
        for j, t in ((jlayers.linear_decay_schedule(1e-3, 40, 0.01),
                      layers.linear_decay_schedule(1e-3, 40, 0.01)),
                     (jlayers.linear_decay_schedule(2e-3, 10),
                      layers.linear_decay_schedule(2e-3, 10)),
                     (jlayers.cosine_warmup_schedule(1e-3, 10, 100),
                      layers.cosine_warmup_schedule(1e-3, 10, 100)),
                     (jlayers.cosine_warmup_schedule(1e-3, 0, 100),
                      layers.cosine_warmup_schedule(1e-3, 0, 100))):
            assert t(step) == pytest.approx(float(j(step)), rel=1e-6,
                                            abs=1e-6 * 2e-3)


def test_layer_norm_and_gelu_follow_flax():
    """The flax defaults the port pins: LayerNorm's epsilon 1e-6 (the
    input's variance here is ~1e-6, where torch's 1e-5 would move the
    output by ~60 %) and GELU's tanh approximation, against flax, atol
    1e-5; both differ from torch's defaults by more than that."""
    import flax.linen as fnn

    rng = np.random.default_rng(2)
    x = (rng.normal(size=(4, 9, 6)) * 1e-3).astype(np.float32)
    want = np.asarray(fnn.LayerNorm().apply({"params": {
        "scale": jnp.ones(6), "bias": jnp.zeros(6)}}, jnp.asarray(x)))
    got = tcn_transformer.LayerNorm(6)(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    torch_ln = torch.nn.functional.layer_norm(torch.from_numpy(x), (6,))
    assert np.abs(torch_ln.numpy() - want).max() > 1e-2
    z = (rng.normal(size=200) * 3).astype(np.float32)
    want = np.asarray(fnn.gelu(jnp.asarray(z)))
    block = tcn_transformer.EncoderBlock(4, 2, 8, 0.0)
    spy = []
    gelu = torch.nn.functional.gelu
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcn_transformer.F, "gelu",
                   lambda a, **kw: (spy.append(kw), gelu(a, **kw))[1])
        block(torch.zeros(1, 3, 4))
    assert spy == [{"approximate": "tanh"}]
    got = gelu(torch.from_numpy(z), approximate="tanh").numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.abs(gelu(torch.from_numpy(z)).numpy() - want).max() > 1e-4


def test_attention_dropout_mask_is_shared_by_batch_and_heads():
    """Attention dropout (flax ``broadcast_dropout``): one (query, key)
    mask for every batch row and head, kept weights scaled by 1/(1 - p),
    about 1 - p of them kept; the attention applies it in training mode
    only, to its (B, heads, T, T) weights."""
    w = torch.rand(5, 3, 40, 40) + 0.5
    got = tcn_transformer._broadcast_dropout(
        w, 0.3, torch.Generator().manual_seed(0))
    kept = got != 0
    assert torch.equal(kept, kept[:1, :1].expand_as(kept))
    torch.testing.assert_close(got[kept], w[kept] / 0.7)
    assert abs(kept[0, 0].float().mean().item() - 0.7) < 0.05

    att = tcn_transformer.MultiHeadAttention(8, 2, dropout=0.5)
    seen = []
    orig = tcn_transformer._broadcast_dropout
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcn_transformer, "_broadcast_dropout",
                   lambda a, *r: (seen.append(tuple(a.shape)),
                                  orig(a, *r))[1])
        x = torch.randn(3, 10, 8)
        with torch.no_grad():
            att.eval()
            att(x)
            att.train()
            a = att(x, torch.Generator().manual_seed(1))
            b = att(x, torch.Generator().manual_seed(1))
    assert seen == [(3, 2, 10, 10)] * 2
    assert torch.equal(a, b)


@pytest.mark.parametrize("family", FAMILIES)
def test_dropout_draws_by_statistics(family):
    """At dropout 0.3 a train-mode forward draws its masks from the given
    generator: the same seed repeats it bitwise, another seed changes it,
    and eval mode draws nothing. The classifier's own dropout keeps about
    0.7 of its entries, scaled by 1/0.7: checked where the masks meet the
    data first, on the conv's output (TCN, CNN-transformer, conv-GRU), the
    first block's attention residual (transformer) and the stack's
    inter-layer output (SimpleGRU)."""
    tm = _port_model(family, dropout=0.3).train()
    x = torch.from_numpy(_batch(n=40)[0])
    g = [torch.Generator().manual_seed(s) for s in (7, 7, 8)]
    with torch.no_grad():
        a, b, c = (tm(x, generator=gi) for gi in g)
        assert torch.equal(a, b) and not torch.equal(a, c)
        tm.eval()
        before = g[0].get_state()
        tm(x, generator=g[0])
        assert torch.equal(g[0].get_state(), before)
    drawn = []
    orig = layers._dropout
    with pytest.MonkeyPatch.context() as mp:
        def spy(v, rate, gen):
            out = orig(v, rate, gen)
            drawn.append((v, out, rate))
            return out
        mp.setattr(layers, "_dropout", spy)
        mp.setattr(tcn_transformer, "_dropout", spy)
        tm.train()
        with torch.no_grad():
            tm(x, generator=torch.Generator().manual_seed(3))
    v, out, rate = drawn[0]
    assert rate == 0.3
    live = v != 0
    kept = (out != 0) & live
    assert abs(kept.sum().item() / live.sum().item() - 0.7) < 0.03
    torch.testing.assert_close(out[kept], v[kept] / 0.7)
    # every dropout site of the model drew: conv (or none), the residuals
    # (3 a block) or the stack's inter-layer masks (NL - 1), fc layers
    want = {"tcn": 2, "transformer": 3 * NL, "cnn_transformer": 1 + 3 * NL,
            "conv_rnn": 1 + NL - 1, "simple_gru": NL - 1}[family]
    assert len(drawn) == want


def test_simple_gru_reads_its_data_in_bf16_without_dx(monkeypatch):
    """SimpleGRU's stack takes its input as data: layer 0 reads it cast to
    bf16 and its backward forms no dx (the JAX package's input_grad=False);
    layer 1 forms its dx. TemporalConvRNN's layers both form theirs."""
    asked = []
    plain = gru.gru_backward_plain

    def spy(x, *a, need_dx=True, **kw):
        asked.append((x.dtype, need_dx))
        return plain(x, *a, need_dx=need_dx, **kw)

    monkeypatch.setattr(gru, "gru_backward_plain", spy)
    x = torch.from_numpy(_batch()[0])
    for family in ("simple_gru", "conv_rnn"):
        tm = _port_model(family).train()
        tm(x).sum().backward()
    assert asked == [(torch.float32, True), (torch.bfloat16, False),
                     (torch.float32, True), (torch.float32, True)]
