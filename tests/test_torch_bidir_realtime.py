"""The bidirectional RealtimeRNN of the port against the JAX package's, on
the CPU.

Weights go into both packages from one flax init through
``realtime_rnn_params_from_flax``, or from one Lightning checkpoint in the
reference's layout through each package's ``realtime_rnn_from_ckpt``. The
port materialises the windows once for both directions and rounds them to
bf16 on every device; the JAX package's kernel path (forced on in
interpret mode, with its fused bidirectional kernel or without) rounds
layer 0's input to bf16 too, so logits agree to float32 roundoff (atol
1e-5), and against the JAX scan path (unrounded windows) to bf16 input
tolerance (atol 5e-2, rtol 1e-2, as tests/test_torch_realtime_rnn.py).
Gradients of the CTC loss at dropout 0 agree to 1e-4 of each tensor's
largest entry (float32 sums over B x n_win terms in another order), and
the parameters after one AdamW step to atol 1e-5: that step moves an entry
by about lr g / (|g| + eps), lr = 1e-3, so an entry whose gradient is
small against those sums' error moves up to a few 1e-6 differently (one
entry of 768 did, by 4e-6, on this test's data).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn as tnn

import cross_patient_speech_decoding_tpu.ops.pallas_gru as pg
from cross_patient_speech_decoding_tpu.cli import experiments as je
from cross_patient_speech_decoding_tpu.models import RealtimeRNN as JaxRNN
from cross_patient_speech_decoding_tpu.models import torch_import as jti
from cross_patient_speech_decoding_tpu.ops import ctc as jctc
from cross_patient_speech_decoding_tpu.train import (
    create_train_state as jax_create_state,
)
from cross_patient_speech_decoding_tpu.train import loops as jloops
from cross_patient_speech_decoding_tpu.train.steps import (
    make_ctc_train_step as jax_train_step,
)
from cross_patient_speech_decoding_tpu.utils.config import (
    RealtimeSimConfig as JaxRtCfg,
)
from cross_patient_speech_decoding_tpu_torch.cli import experiments as te
from cross_patient_speech_decoding_tpu_torch.models import (
    RealtimeRNN,
    adjusted_input_lengths,
    realtime_rnn_params_from_flax,
)
from cross_patient_speech_decoding_tpu_torch.models import torch_import as ti
from cross_patient_speech_decoding_tpu_torch.ops import ctc
from cross_patient_speech_decoding_tpu_torch.train import (
    create_train_state,
    make_ctc_train_step,
    make_optimizer,
)
from cross_patient_speech_decoding_tpu_torch.utils.config import (
    RealtimeSimConfig,
)

torch.set_num_threads(2)

KW = dict(hidden=16, n_layers=2, n_classes=7, win_size=6, stride=2)
B, T, C, L = 6, 30, 4, 3
N_WIN = (T - KW["win_size"]) // KW["stride"] + 1
LOGITS_ATOL = 1e-5
GRAD_RTOL = 1e-4
PARAM_ATOL = 1e-5


@pytest.fixture
def jax_kernel_path(monkeypatch):
    monkeypatch.setattr(pg, "enabled", lambda: True)
    monkeypatch.setattr(pg, "worthwhile", lambda B, T: True)


def _pair(seed=0, dropout=0.0):
    jm = JaxRNN(bidirectional=True, input_grad=False, dropout=dropout, **KW)
    probe = jnp.zeros((1, 4 * KW["win_size"], C), jnp.float32)
    params = jm.init({"params": jax.random.key(seed)}, probe, True)
    tm = RealtimeRNN(C, KW["hidden"], KW["n_layers"], KW["n_classes"],
                     dropout=dropout, win_size=KW["win_size"],
                     stride=KW["stride"], bidirectional=True, seed=seed,
                     device="cpu")
    tm.load_state_dict(realtime_rnn_params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    tm.eval()
    return jm, params, tm


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, C)).astype(np.float32)
    labels = rng.integers(1, KW["n_classes"], size=(B, L)).astype(np.int32)
    il = rng.integers(22, T + 1, size=B).astype(np.int32)
    ll = rng.integers(1, L + 1, size=B).astype(np.int32)
    return x, labels, il, ll


def _apply(jm):
    """The JAX model's eval-mode forward, jitted (interpret-mode Pallas
    runs faster traced once than op by op)."""
    return jax.jit(lambda p, x: jm.apply(p, x, True))


def _flat(params):
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    return {".".join(p.key for p in path): np.asarray(v) for path, v in flat}


@pytest.mark.parametrize("fused", [False, True])
def test_logits_match_jax_kernel_path(jax_kernel_path, monkeypatch, fused):
    """Against the JAX kernel path: two ``_fwd_kernel`` sweeps a layer
    (its default, ``BIDIR_FUSED`` off) or one ``_bifwd_kernel``."""
    monkeypatch.setattr(pg, "BIDIR_FUSED", fused)
    jm, params, tm = _pair(seed=1)
    x = _batch(1)[0]
    want = np.asarray(_apply(jm)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (B, N_WIN, KW["n_classes"])
    np.testing.assert_allclose(got, want, atol=LOGITS_ATOL)


def test_logits_match_jax_scan_path_to_bf16_tolerance():
    jm, params, tm = _pair(seed=2)
    x = _batch(2)[0]
    want = np.asarray(_apply(jm)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=5e-2, rtol=1e-2)


def test_tree_h0_init_and_initial_hidden():
    """The flax tree's names and shapes (``bwd{l}``, a 2H head); ``h0``
    (2 n_layers, 1, H) xavier-uniform with flax's receptive field
    n_layers * 2, so bound sqrt(6 / (2 n_layers (1 + H))); the initial
    state broadcast to (2 n_layers, B, H) as JAX's ``initial_hidden``;
    ``single_step`` refuses the model."""
    jm, params, tm = _pair()
    want = {k: v.shape for k, v in _flat(params["params"]).items()}
    fresh = RealtimeRNN(C, 64, 3, 7, win_size=6, stride=2,
                        bidirectional=True, seed=5, device="cpu")
    got = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert got == want
    assert got["h0"] == (4, 1, 16) and got["head.kernel"] == (32, 7)
    h0 = fresh.h0.detach().numpy()
    bound = np.sqrt(6.0 / (3 * 2 * (1 + 64)))
    # 384 uniform draws: the largest lies within 1 % of the bound
    assert 0.99 * bound < np.abs(h0).max() <= bound
    np.testing.assert_array_equal(
        tm.initial_hidden(4).detach().numpy(),
        np.asarray(jm.apply(params, 4, method=JaxRNN.initial_hidden)))
    with pytest.raises(ValueError, match="unidirectional"):
        tm.single_step(torch.zeros(1, 6 * C), torch.zeros(2, 1, 16))


def test_ctc_grads_and_train_step_match_jax(jax_kernel_path):
    """Dropout 0: every parameter's gradient of the CTC loss, then one
    ``make_ctc_train_step`` step with AdamW against JAX's."""
    jm, params, tm = _pair(seed=3)
    x, labels, il, ll = _batch(3)
    in_adj = (il - 6) // 2 + 1

    def loss_j(p):
        logits = jm.apply({"params": p}, jnp.asarray(x), True)
        return jctc.ctc_loss_mean(logits, jnp.asarray(in_adj),
                                  jnp.asarray(labels), jnp.asarray(ll))

    lj, gj = jax.jit(jax.value_and_grad(loss_j))(params["params"])
    want = _flat(gj)
    tm.train()
    logits = tm(torch.from_numpy(x))
    loss = ctc.ctc_loss_mean(
        logits, adjusted_input_lengths(torch.from_numpy(il), 6, 2),
        torch.from_numpy(labels), torch.from_numpy(ll))
    names, ps = zip(*tm.named_parameters())
    got = dict(zip(names, torch.autograd.grad(loss, ps)))
    np.testing.assert_allclose(float(loss.detach()), float(lj), rtol=1e-5)
    assert set(got) == set(want)
    for name, w in want.items():
        err = np.abs(got[name].numpy() - w).max()
        assert err <= GRAD_RTOL * np.abs(w).max() + 1e-8, (name, err)
    assert np.abs(want["h0"]).max() > 0
    assert np.abs(want["rnn.bwd0.wi"]).max() > 0

    tx_j = jloops.make_optimizer(1e-3, 1e-5, 2, clip=5.0)
    state_j = jax_create_state(jm, params, tx_j)
    state_j, mj = jax.jit(jax_train_step(jm, tx_j))(
        state_j, tuple(jnp.asarray(a) for a in (x, labels, il, ll)),
        jax.random.key(0))
    tx = make_optimizer(1e-3, 1e-5, 2, clip=5.0)
    state, m = make_ctc_train_step(tm, tx)(
        create_train_state(tm, tx),
        tuple(torch.from_numpy(a) for a in (x, labels, il, ll)), None)
    np.testing.assert_allclose(float(m["loss"]), float(mj["loss"]),
                               rtol=1e-5)
    after = tm.state_dict()
    for name, w in _flat(state_j.params).items():
        np.testing.assert_allclose(after[name].numpy(), w, atol=PARAM_ATOL,
                                   err_msg=name)


def _bidir_ckpt(tmp_path, C_=3, win=6, stride=2, H=8, n_layers=2, K=11):
    torch.manual_seed(4)
    rnn = tnn.GRU(win * C_, H, num_layers=n_layers, batch_first=True,
                  bidirectional=True)
    head = tnn.Linear(2 * H, K)
    sd = {f"rnn.rnn.{k}": v for k, v in rnn.state_dict().items()}
    sd["h0"] = torch.randn(2 * n_layers, 1, H) * 0.1
    sd.update({f"classifier.fc.{k}": v for k, v in head.state_dict().items()})
    path = tmp_path / "bi.ckpt"
    torch.save({"state_dict": sd, "hyper_parameters": {
        "hidden_size": H, "n_layers": n_layers, "n_classes": K,
        "win_size": win, "stride": stride, "bidirectional": True,
        "dropout": 0.0}}, path)
    return path, {k: v.numpy() for k, v in sd.items()}


def test_realtime_rnn_from_ckpt_bidirectional(tmp_path, jax_kernel_path):
    """A bidirectional checkpoint: weights bit for bit JAX's import, logits
    against JAX's model on its kernel path, and the inverse map back to the
    reference's keys."""
    path, sd = _bidir_ckpt(tmp_path)
    model = ti.realtime_rnn_from_ckpt(path, device="cpu").eval()
    jm, jvars = jti.realtime_rnn_from_ckpt(path)
    assert model.bidirectional and jm.bidirectional
    want = _flat(jvars["params"])
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    x = np.random.default_rng(6).normal(size=(4, 26, 3)).astype(np.float32)
    with torch.no_grad():
        lt = model(torch.from_numpy(x)).numpy()
    lj = np.asarray(_apply(jm)(jvars, jnp.asarray(x)))
    np.testing.assert_allclose(lt, lj, atol=LOGITS_ATOL)
    back = ti.realtime_rnn_to_state_dict(model)
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k])


def test_realtime_sim_refuses_a_bidirectional_checkpoint(tmp_path):
    """Both packages' ``run_realtime_sim`` raise JAX's ``ValueError`` for a
    bidirectional checkpoint (JAX cli/experiments.py:2178-2182). For
    ``run_train_ctc init_ckpt=`` see tests/test_torch_ctc_driver.py."""
    path, _ = _bidir_ckpt(tmp_path)
    with pytest.raises(ValueError, match="unidirectional"):
        te.run_realtime_sim(RealtimeSimConfig(n_bins=20, ckpt=str(path)),
                            device="cpu")
    with pytest.raises(ValueError, match="unidirectional"):
        je.run_realtime_sim(JaxRtCfg(n_bins=20, ckpt=str(path)))
