"""Port GRU gradients against the JAX package's custom VJPs.

The same numpy inputs and the same numpy cotangent dhs go to ``jax.vjp``
of ``pallas_gru.gru_layer`` / ``gru_layer_windowed`` (Pallas kernels in
interpret mode on the CPU backend, as tests/test_pallas_gru.py runs them)
and to the port's autograd, which on CPU tensors runs the plain backward
versions. Both sides accumulate in float32: atol 1e-5 on every gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_patient_speech_decoding_tpu.models.layers import (
    reformat_time_windows as jax_reformat,
)
from cross_patient_speech_decoding_tpu.ops import pallas_gru
from cross_patient_speech_decoding_tpu_torch.ops import gru

torch.set_num_threads(2)

ATOL = 1e-5
NAMES = ("x", "h0", "wi", "bi", "wh", "bh")


def _case(seed=0, T=6, B=16, F=10, H=32):
    # the shapes and scales of tests/test_pallas_gru.py:_case
    rng = np.random.default_rng(seed)
    return [
        (rng.normal(size=(T, B, F)) * 0.5).astype(np.float32),
        (rng.normal(size=(B, H)) * 0.3).astype(np.float32),
        (rng.normal(size=(F, 3 * H)) / np.sqrt(F)).astype(np.float32),
        (rng.normal(size=(3 * H,)) * 0.1).astype(np.float32),
        (rng.normal(size=(H, 3 * H)) / np.sqrt(H)).astype(np.float32),
        (rng.normal(size=(3 * H,)) * 0.1).astype(np.float32),
    ]


def _win_case(seed=0, T=26, B=16, C=5, H=32, win=6):
    # tests/test_pallas_gru.py:_win_case
    args = _case(seed, T=T, B=B, F=C, H=H)
    rng = np.random.default_rng(seed + 100)
    F = win * C
    args[2] = (rng.normal(size=(F, 3 * H)) / np.sqrt(F)).astype(np.float32)
    return args


def _dhs(shape, seed):
    return np.random.default_rng(seed + 50).normal(size=shape).astype(
        np.float32)


def _leaves(args, grad_from=0):
    return [torch.tensor(a, requires_grad=i >= grad_from)
            for i, a in enumerate(args)]


def _port_grads(fn, args, dhs, grad_from=0):
    ts = _leaves(args, grad_from)
    hs = fn(*ts)
    hs.backward(torch.from_numpy(dhs))
    return hs.detach().numpy(), [t.grad for t in ts]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", [dict(T=6, B=16, F=10, H=32),
                                   dict(T=5, B=10, F=9, H=50)])
def test_gru_layer_grads_match_pallas_vjp(reverse, shape):
    args = _case(seed=3, **shape)
    hs_j, vjp = jax.vjp(
        lambda *a: pallas_gru.gru_layer(*a, reverse),
        *[jnp.asarray(a) for a in args])
    dhs = _dhs(hs_j.shape, 3)
    want = vjp(jnp.asarray(dhs))
    hs, got = _port_grads(lambda *a: gru.gru_layer(*a, reverse=reverse),
                          args, dhs)
    np.testing.assert_allclose(hs, np.asarray(hs_j), atol=ATOL)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("reverse", [False, True])
def test_data_input_param_grads_unchanged_and_no_dx(reverse, monkeypatch):
    """x that needs no gradient (the JAX input_grad=False case,
    tests/test_pallas_gru.py:212): the parameter gradients are the same,
    and the backward is asked for no dx."""
    args = _case(seed=4)
    dhs = _dhs((6, 16, 32), 4)
    _, full = _port_grads(lambda *a: gru.gru_layer(*a, reverse=reverse),
                          args, dhs)
    asked = []
    plain = gru.gru_backward_plain

    def spy(*a, need_dx=True, **kw):
        asked.append(need_dx)
        return plain(*a, need_dx=need_dx, **kw)

    monkeypatch.setattr(gru, "gru_backward_plain", spy)
    _, data = _port_grads(lambda *a: gru.gru_layer(*a, reverse=reverse),
                          args, dhs, grad_from=1)
    assert asked == [False] and data[0] is None
    for name, g, w in zip(NAMES[1:], data[1:], full[1:]):
        torch.testing.assert_close(g, w, atol=0, rtol=0, msg=name)


def test_bf16_input_grads_match_pallas_vjp():
    """bf16 x: dWi is formed from the bf16-rounded x
    (tests/test_pallas_gru.py:263), and dx comes back in bf16."""
    args = _case(seed=5)
    xb = jnp.asarray(args[0]).astype(jnp.bfloat16)
    hs_j, vjp = jax.vjp(lambda x, *p: pallas_gru.gru_layer(x, *p),
                        xb, *[jnp.asarray(a) for a in args[1:]])
    dhs = _dhs(hs_j.shape, 5)
    want = vjp(jnp.asarray(dhs))
    ts = _leaves(args)
    x_bf = ts[0].detach().to(torch.bfloat16).requires_grad_()
    hs = gru.gru_layer(x_bf, *ts[1:])
    hs.backward(torch.from_numpy(dhs))
    assert x_bf.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(x_bf.grad.float().numpy(),
                               np.asarray(want[0].astype(jnp.float32)),
                               atol=1e-2, rtol=1e-2)  # both rounded to bf16
    for name, t, w in zip(NAMES[1:], ts[1:], want[1:]):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=ATOL,
                                   err_msg=name)
    # against the f32 x, dWi differs: it is built from the rounded x
    _, full = _port_grads(gru.gru_layer, args, dhs)
    assert not torch.allclose(full[2], ts[2].grad, atol=ATOL, rtol=0)


@pytest.mark.parametrize("win,stride,T", [(6, 2, 26), (6, 2, 27), (5, 2, 25),
                                          (4, 4, 16), (7, 3, 23)])
def test_windowed_grads_match_pallas_vjp(win, stride, T):
    """Several strides, with trailing frames that no window reads
    (tests/test_pallas_gru.py:314,327,439). The frames require a gradient
    here, so the op reads them rounded to bf16, as the Pallas op is fed
    them, and gives them one: ``jax.vjp`` of the scan oracle over the
    windows of the rounded frames (0 on the trailing frames)."""
    args = _win_case(T=T, win=win)
    x_j = jnp.asarray(args[0]).astype(jnp.bfloat16)
    params = [jnp.asarray(a) for a in args[1:]]
    hs_j, vjp = jax.vjp(
        lambda *p: pallas_gru.gru_layer_windowed(x_j, *p, win, stride),
        *params)
    dhs = _dhs(hs_j.shape, T)
    want = vjp(jnp.asarray(dhs))
    _, vjp_x = jax.vjp(
        lambda xx: pallas_gru.gru_layer_reference(
            jax_reformat(xx.swapaxes(0, 1), win, stride).swapaxes(0, 1),
            *params), x_j.astype(jnp.float32))
    (want_dx,) = vjp_x(jnp.asarray(dhs))
    ts = _leaves(args)
    hs = gru.gru_layer_windowed(*ts, win, stride)
    hs.backward(torch.from_numpy(dhs))
    np.testing.assert_allclose(hs.detach().numpy(), np.asarray(hs_j),
                               atol=ATOL)
    assert ts[0].grad.dtype == torch.float32
    np.testing.assert_allclose(ts[0].grad.numpy(), np.asarray(want_dx),
                               atol=ATOL, err_msg="x")
    assert not ts[0].grad[(T - win) // stride * stride + win:].any()
    for name, t, w in zip(NAMES[1:], ts[1:], want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=ATOL,
                                   err_msg=name)


def test_windowed_grads_odd_sizes_bf16_frames():
    """B=10, H=50 and bf16 batch-major frames, the model's layer-0 call."""
    args = _win_case(T=27, B=10, H=50)
    x_j = jnp.asarray(args[0]).astype(jnp.bfloat16)
    hs_j, vjp = jax.vjp(
        lambda *p: pallas_gru.gru_layer_windowed(x_j, *p, 6, 2),
        *[jnp.asarray(a) for a in args[1:]])
    dhs = _dhs(hs_j.shape, 9)
    want = vjp(jnp.asarray(dhs))
    ts = _leaves(args)
    x_view = ts[0].detach().transpose(0, 1).contiguous().to(
        torch.bfloat16).transpose(0, 1)
    hs = gru.gru_layer_windowed(x_view, *ts[1:], 6, 2)
    hs.backward(torch.from_numpy(dhs))
    for name, t, w in zip(NAMES[1:], ts[1:], want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("reverse", [False, True])
def test_plain_backward_matches_autograd_through_plain_forward(reverse):
    """The plain backward function against torch.autograd through the
    plain forward's step loop, with hprev built as the Function does."""
    args = _case(seed=6, T=5, B=10, F=9, H=50)
    dhs = _dhs((5, 10, 50), 6)
    hs, want = _port_grads(
        lambda *a: gru.gru_layer_plain(*a, reverse=reverse), args, dhs)
    ts = [torch.from_numpy(a) for a in args]
    hs_t = torch.from_numpy(hs)
    if reverse:
        hprev = torch.cat([hs_t[1:], ts[1][None]])
    else:
        hprev = torch.cat([ts[1][None], hs_t[:-1]])
    dx, dh0, dwi, dwh, dbi, dbh = gru.gru_backward_plain(
        ts[0], hprev, torch.from_numpy(dhs), *ts[2:], reverse=reverse)
    for name, g, w in zip(NAMES, (dx, dh0, dwi, dbi, dwh, dbh), want):
        torch.testing.assert_close(g, w, atol=ATOL, rtol=0, msg=name)
    assert gru.gru_backward_plain(ts[0], hprev, torch.from_numpy(dhs),
                                  *ts[2:], reverse, need_dx=False)[0] is None


def test_plain_windowed_backward_matches_autograd():
    args = _win_case(seed=7, T=27)
    dhs = _dhs((11, 16, 32), 7)
    ts = _leaves(args, grad_from=1)
    hs = gru.gru_layer_windowed_plain(*ts, 6, 2)
    hs.backward(torch.from_numpy(dhs))
    hprev = torch.cat([ts[1].detach()[None], hs.detach()[:-1]])
    got = gru.gru_win_backward_plain(ts[0], hprev, torch.from_numpy(dhs),
                                     *[t.detach() for t in ts[2:]], 6, 2)
    assert got[0] is None
    dh0, dwi, dwh, dbi, dbh = got[1:]
    for name, g, t in zip(NAMES[1:], (dh0, dwi, dbi, dwh, dbh), ts[1:]):
        torch.testing.assert_close(g, t.grad, atol=ATOL, rtol=0, msg=name)


def test_incoming_gradient_may_be_a_strided_view():
    """dhs arrives as a transposed or expanded view (FusedGRU returns hs
    transposed); the backward takes it as it is."""
    args = _case(seed=8)
    ts = _leaves(args)
    hs = gru.gru_layer(*ts)
    (hs.transpose(0, 1).sum() + hs[-1].sum()).backward()
    ts2 = _leaves(args)
    hs2 = gru.gru_layer(*ts2)
    dhs = torch.ones_like(hs2)
    dhs[-1] += 1
    hs2.backward(dhs)
    for name, a, b in zip(NAMES, ts, ts2):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-6, rtol=0,
                                   msg=name)
