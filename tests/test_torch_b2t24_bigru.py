"""The Brain-to-Text '24 baseline (``BrainToTextGRU`` with ``bidirectional``,
a zero initial state and the Gaussian smoothing) and the frames' gradient
out of a bidirectional windowed GRU layer 0, against the benchmark's plain
reference (``portbench/reference/b2t24_bigru.py``) and autograd.

CPU cases, at a small size (C 6, window 4, stride 2, H 16, 3 layers, 5
days, B 8, unequal lengths), with seeded random weights; the port runs its
plain GRU versions, and, where a case says so, its kernels' route with the
kernel wrappers replaced by those plain versions. Tolerances as in
``test_torch_b2t_gru.py``: float32 sums over at most a few hundred terms
in another order agree to GRAD_RTOL x a tensor's largest value, the logits
and the loss to LOGIT_ATOL of theirs; the noise and the per-row products
that run the same operations on the same rows are compared bit for bit.

Card cases (``gpu``; they skip without a card, and run there with
``python -m pytest tests/test_torch_b2t24_bigru.py --noconftest -m gpu``):
the bidirectional windowed op at the cell's published widths (289 windows
of 32 x 256 over 1,184 frames, B 64, H 1,024) and a ragged shape against
its plain version on the card, its frames' gradient the sum of the two
directions' ``gru_wbwd`` folds bit for bit, two runs bitwise equal.
"""

import pytest
import torch

from cross_patient_speech_decoding_tpu_torch.models import BrainToTextGRU
from cross_patient_speech_decoding_tpu_torch.models import layers
from cross_patient_speech_decoding_tpu_torch.models.layers import (
    DayAffine,
    StackedRNN,
    smooth_time,
)
from cross_patient_speech_decoding_tpu_torch.ops import gru
from cross_patient_speech_decoding_tpu_torch.train import (
    create_train_state,
    make_ctc_train_step,
    make_optimizer,
)
from cross_patient_speech_decoding_tpu_torch.train.steps import _augment
from cross_patient_speech_decoding_tpu_torch.utils import profiling
from portbench.core.weights import draw, load_into
from portbench.reference import b2t24_bigru as ref
from portbench.reference.common import gru as ref_gru

GRAD_RTOL = 2e-5
LOGIT_ATOL = 2e-5

CFG = {"in_channels": 6, "n_days": 5, "hidden": 16, "n_layers": 3,
       "bidirectional": True, "n_classes": 7, "blank": 0, "win_size": 4,
       "stride": 2, "dropout": 0.4, "smooth_sigma": 2.0,
       "augment": {"white_sd": 0.8, "offset_sd": 0.2},
       "betas": [0.9, 0.999],
       # a weight decay large enough that its coupling shows
       "optimizer": {"lr": 0.02, "weight_decay": 0.01, "decay_steps": 10,
                     "end_factor": 1.0, "eps": 0.1, "decoupled": False}}
CPU = torch.device("cpu")
SCATTERED = (4, 1, 4, 1, 0, 4, 2, 2)


def _close(got, want, rtol=GRAD_RTOL):
    tol = rtol * float(want.abs().max())
    torch.testing.assert_close(got, want, atol=tol, rtol=0)


def _model(seed=3):
    m = BrainToTextGRU(CFG["in_channels"], CFG["hidden"], CFG["n_layers"],
                       CFG["n_classes"], n_days=CFG["n_days"],
                       input_dropout=0.0, dropout=CFG["dropout"],
                       win_size=CFG["win_size"], stride=CFG["stride"],
                       device="cpu", bidirectional=True, learned_h0=False,
                       smooth_sigma=CFG["smooth_sigma"])
    w = draw(ref.leaves(CFG), seed, CPU)
    load_into(m, w)
    return m, w


def _batch(seed=0, days=SCATTERED, B=8, T=24):
    g = torch.Generator().manual_seed(seed)
    il = torch.tensor([24, 19, 15, 24, 11, 20, 22, 14], dtype=torch.int32)
    x = torch.randn(B, T, CFG["in_channels"], generator=g)
    x[torch.arange(T)[None, :] >= il[:, None]] = 0.0
    ll = torch.tensor([3, 2, 2, 4, 1, 3, 2, 2], dtype=torch.int32)
    labels = torch.randint(1, CFG["n_classes"], (B, 4), generator=g,
                           dtype=torch.int32)
    return x, labels, il, ll, torch.tensor(days)


def _layer_args(seed, T, B, C, H, win):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(T, B, C, generator=g)
    out = [x]
    for _ in range(2):
        out.append(torch.randn(B, H, generator=g) * 0.3)
    for _ in range(2):
        out += [torch.randn(win * C, 3 * H, generator=g) / (win * C) ** 0.5,
                torch.randn(3 * H, generator=g) * 0.1,
                torch.randn(H, 3 * H, generator=g) / H ** 0.5,
                torch.randn(3 * H, generator=g) * 0.1]
    return out


def _kernel_route(monkeypatch):
    """The kernels' route on the CPU: the wrappers are the plain versions."""
    monkeypatch.setattr(gru, "_route", lambda x: "cuda")
    monkeypatch.setattr(gru, "_batch_major", lambda x: x)
    monkeypatch.setattr(gru, "product_counts",
                        lambda: {"wgmma": 0, "mma_sync": 0})
    monkeypatch.setattr(gru, "gru_wfwd_cuda", gru.gru_layer_windowed_plain)
    monkeypatch.setattr(gru, "gru_wbwd_cuda", gru.gru_win_backward_plain)


# ---------------------------------------------------------------------------
# the bidirectional windowed layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("plain_route", [True, False])
@pytest.mark.parametrize("T", [21, 24])
def test_bidir_windowed_layer_matches_autograd(monkeypatch, plain_route, T):
    """``gru_layer_bidir_windowed`` at window 4, stride 2 against autograd
    through the reference's straight-through bf16 windows and its GRU,
    forward and reversed: both directions' states and every gradient, the
    frames' included (float32, past the rounding); a ``gru_wfwd`` and a
    ``gru_wbwd`` span a direction, the reversed one's marked."""
    if not plain_route:
        _kernel_route(monkeypatch)
    B, C, H, win, stride = 3, 5, 8, 4, 2
    args = _layer_args(7, T, B, C, H, win)
    n_win = gru.n_windows(T, win, stride)
    g = torch.Generator().manual_seed(8)
    dhs = [torch.randn(n_win, B, H, generator=g) for _ in range(2)]
    xp = args[0].transpose(0, 1).contiguous().requires_grad_(True)
    leaves = [t.clone().requires_grad_(True) for t in args[1:]]
    profiling.reset()
    with profiling.recording():
        hs = gru.gru_layer_bidir_windowed(xp.transpose(0, 1), *leaves, win,
                                          stride)
        torch.autograd.backward(hs, dhs)
    recs = profiling.spans()
    profiling.reset()
    xr = xp.detach().clone().requires_grad_(True)
    rl = [t.clone().requires_grad_(True) for t in args[1:]]
    w = ref.patches({"win_size": win, "stride": stride}, xr).transpose(0, 1)
    want = (ref_gru(w, rl[0], *rl[2:6]),
            ref_gru(w, rl[1], *rl[6:10], reverse=True))
    for a, b in zip(hs, want):
        _close(a.detach(), b.detach(), rtol=LOGIT_ATOL)
    torch.autograd.backward(want, dhs)
    assert xp.grad.dtype == torch.float32
    _close(xp.grad, xr.grad)
    for a, b in zip(leaves, rl):
        _close(a.grad, b.grad)
    # a gradient rounded to bf16 would sit on the bf16 grid
    assert not torch.equal(xp.grad, xp.grad.to(torch.bfloat16).float())
    bwd = [r["attrs"] for r in recs if r["name"] == "gru_wbwd"]
    assert sorted((a.get("reverse", False), a["need_dx"], a["fold"])
                  for a in bwd) == [(False, True, 2), (True, True, 2)]
    fwd = [r["attrs"] for r in recs if r["name"] == "gru_wfwd"]
    assert [a.get("reverse", False) for a in fwd] == [False, True]
    assert all(a["directions"] == 1 and a["T"] == n_win
               and a["F"] == win * C for a in fwd)
    assert all(a["route"] == ("plain" if plain_route else "cuda")
               for a in fwd + bwd)


def test_frames_gradient_is_the_two_folds_added():
    """The frames' gradient is the forward direction's fold plus the
    reversed one's, bit for bit (the windowed backward with ``reverse``)."""
    T, B, C, H, win, stride = 19, 2, 3, 8, 4, 2
    x, h0_f, h0_b, *w = _layer_args(11, T, B, C, H, win)
    xp = x.clone().requires_grad_(True)
    hs = gru.gru_layer_bidir_windowed(xp, h0_f, h0_b, *w, win, stride)
    dhs = [torch.randn_like(h) for h in hs]
    torch.autograd.backward(hs, dhs)
    xb = x.to(torch.bfloat16)
    hs = [h.detach() for h in hs]
    parts = [gru.gru_win_backward_plain(
        xb, torch.cat([h0_f[None], hs[0][:-1]]), dhs[0], *w[:4], win,
        stride, need_dx=True)[0],
        gru.gru_win_backward_plain(
        xb, torch.cat([hs[1][1:], h0_b[None]]), dhs[1], *w[4:], win,
        stride, need_dx=True, reverse=True)[0]]
    assert torch.equal(xp.grad, parts[0] + parts[1])


# ---------------------------------------------------------------------------
# the stack's routing
# ---------------------------------------------------------------------------


def _stack(seed=5, C=4, win=4):
    return StackedRNN(win * C, 8, 2, bidirectional=True,
                      generator=torch.Generator().manual_seed(seed))


def test_stack_routes_training_frames_to_the_windowed_op():
    """Frames that train go through ``gru_layer_bidir_windowed`` (no
    window stream, a frames' gradient); data frames, and frames of a stack
    without ``input_grad``, keep the materialised bf16 windows and
    ``gru_layer_bidir``, bit for bit as a stack fed those windows."""
    stack = _stack()
    x = torch.randn(3, 18, 4, generator=torch.Generator().manual_seed(1))
    win = (4, 2)
    windows = gru.reformat_time_windows(x.to(torch.bfloat16), *win)
    want, _ = stack(windows)
    names = {}
    for case, frames, s in (("data", x, stack),
                            ("trains", x.clone().requires_grad_(True),
                             stack)):
        profiling.reset()
        with profiling.recording():
            out, _ = s(frames, window=win)
        names[case] = [r["name"] for r in profiling.spans()
                       if r["name"] in gru.LAUNCHES]
        if case == "data":
            assert torch.equal(out, want)
        else:
            _close(out.detach(), want.detach(), rtol=LOGIT_ATOL)
            out.sum().backward()
            assert frames.grad is not None and frames.grad.abs().sum() > 0
    profiling.reset()
    assert names == {"data": ["gru_bifwd", "gru_bifwd"],
                     "trains": ["gru_wfwd", "gru_wfwd", "gru_bifwd"]}
    frozen = StackedRNN(16, 8, 2, bidirectional=True, input_grad=False,
                        generator=torch.Generator().manual_seed(5))
    frozen.load_state_dict(stack.state_dict())
    assert torch.equal(frozen(x.clone().requires_grad_(True), window=win)[0],
                       want)


# ---------------------------------------------------------------------------
# the input stage
# ---------------------------------------------------------------------------


def test_day_affine_scattered_rows_match_the_per_day_path(monkeypatch):
    """A shuffled batch (days scattered over its rows) runs one product a
    day over the rows sorted by day, with one index copy a batch; output
    and every gradient bit for bit the per-day path's over the same rows
    brought together beforehand."""
    torch.manual_seed(0)
    layer = DayAffine(5, 6)
    with torch.no_grad():
        layer.w.add_(torch.randn_like(layer.w) * 0.3)
        layer.b.add_(torch.randn_like(layer.b) * 0.1)
    copies = []
    real = layers._rows_index
    monkeypatch.setattr(layers, "_rows_index",
                        lambda rows, dev: copies.append(rows)
                        or real(rows, dev))
    x = torch.randn(8, 7, 6, requires_grad=True)
    dy = torch.randn(8, 7, 6)
    profiling.reset()
    with profiling.recording():
        y = layer(x, torch.tensor(SCATTERED))
        y.backward(dy)
    paths = [r["attrs"]["path"] for r in profiling.spans()
             if r["name"] == "day_layer"]
    profiling.reset()
    order = [0, 2, 5, 1, 3, 4, 6, 7]  # days 4, 1, 0, 2 as they appear
    assert copies == [order]
    assert paths == ["sorted", "sorted"]
    gw, gb = layer.w.grad.clone(), layer.b.grad.clone()
    layer.zero_grad()
    xs = x.detach()[order].clone().requires_grad_(True)
    ys = layer(xs, torch.tensor(SCATTERED)[order])
    ys.backward(dy[order])
    assert len(copies) == 1  # the contiguous batch copies no index
    assert torch.equal(y.detach()[order], ys.detach())
    assert torch.equal(x.grad[order], xs.grad)
    assert torch.equal(gw, layer.w.grad) and torch.equal(gb, layer.b.grad)


def test_smoothing_and_noise_match_the_reference():
    """The smoothing kernel, the 'same' convolution padded 9 before and
    10 after, and the trainer's noise drawn in the reference's order from
    one generator."""
    m, _ = _model()
    assert torch.equal(m.smooth_kernel, ref.kernel(CFG))
    assert "smooth_kernel" in m.state_dict() and "smooth_kernel" not in \
        dict(m.named_parameters())
    x = torch.randn(3, 40, 6, generator=torch.Generator().manual_seed(2))
    _close(smooth_time(x, m.smooth_kernel), ref.smooth(CFG, x),
           rtol=LOGIT_ATOL)
    # torch's 'same' padding of an even kernel: 9 frames before, 10 after,
    # so an impulse at the first frame reaches 10 frames, at the last 11
    k = m.smooth_kernel
    pulse = torch.zeros(1, 40, 6)
    pulse[0, 0] = pulse[0, -1] = 1.0
    got = smooth_time(pulse, k)[0, :, 0]
    assert torch.equal(got[:10], k[:10].flip(0))
    assert torch.equal(got[-11:], k[9:].flip(0))
    assert not got[10:-11].any()
    g1 = torch.Generator().manual_seed(9)
    g2 = torch.Generator().manual_seed(9)
    assert torch.equal(_augment(x, (0.8, 0.2), g1), ref.noisy(CFG, x, g2))
    assert torch.equal(torch.rand(3, generator=g1),
                       torch.rand(3, generator=g2))


# ---------------------------------------------------------------------------
# the model and its training against the reference
# ---------------------------------------------------------------------------


def test_logits_match_the_reference():
    m, w = _model()
    x, labels, il, ll, days = _batch()
    m.eval()
    with torch.no_grad():
        got = m(x, days)
        want = ref.forward(CFG, w, x, days)
    assert got.shape == (8, gru.n_windows(24, 4, 2), CFG["n_classes"])
    _close(got, want, rtol=LOGIT_ATOL)
    assert "h0" not in dict(m.named_parameters())


def test_two_train_steps_match_the_reference():
    """``make_ctc_train_step`` with the trainer's noise and Adam with
    coupled L2, dropout on: each step's loss, the first step's gradients
    as Adam took them (weight decay added), the weights after, on a
    shuffled batch and then one drawn day by day; the day layers'
    gradient non-zero for the days present."""
    m, w = _model()
    aug = CFG["augment"]
    tx = make_optimizer(**CFG["optimizer"])
    state = create_train_state(m, tx)
    assert type(state.optimizer) is torch.optim.Adam
    step = make_ctc_train_step(m, tx, augment=(aug["white_sd"],
                                               aug["offset_sd"]))
    batches = [_batch(0), _batch(1, days=(0, 0, 3, 3, 3, 2, 2, 2))]
    gen = torch.Generator().manual_seed(21)
    losses = []
    for k, b in enumerate(batches):
        state, met = step(state, b, gen)
        losses.append(float(met["loss"]))
        if k == 0:
            first = {n: state.optimizer.state[q]["exp_avg"] / 0.1
                     for n, q in m.named_parameters()}
    out = ref.train_steps(CFG, w, batches, 21)
    assert losses == pytest.approx(out["losses"], rel=LOGIT_ATOL)
    for name, q in m.named_parameters():
        _close(first[name], out["grads"][name])
        _close(q.detach() - w[name], out["params"][name] - w[name])
    decay = CFG["optimizer"]["weight_decay"]
    day_grad = first["day.w"] - decay * w["day.w"]
    assert all(day_grad[d].abs().sum() > 0 for d in set(SCATTERED))
    assert state.step == 2


def test_coupled_adam_is_torch_adam():
    """``make_optimizer(decoupled=False)`` is ``torch.optim.Adam`` with its
    ``weight_decay``, at a constant rate where ``end_factor`` is 1."""
    g = torch.Generator().manual_seed(4)
    p0 = [torch.randn(5, 3, generator=g), torch.randn(7, generator=g)]
    grads = [[torch.randn(p.shape, generator=g) for p in p0]
             for _ in range(3)]
    a = [p.clone().requires_grad_(True) for p in p0]
    b = [p.clone().requires_grad_(True) for p in p0]
    tx = make_optimizer(0.02, 0.01, 10, end_factor=1.0, eps=0.1,
                        decoupled=False)
    opt, sched = tx.init(a)
    want = torch.optim.Adam(b, lr=0.02, betas=(0.9, 0.999), eps=0.1,
                            weight_decay=0.01)
    for gs in grads:
        for p, q, gr in zip(a, b, gs):
            p.grad, q.grad = gr.clone(), gr.clone()
        opt.step()
        sched.step()
        want.step()
        assert opt.param_groups[0]["lr"] == 0.02
    assert all(torch.equal(p, q) for p, q in zip(a, b))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _card_layer(card, seed, T, B, C, H, win):
    args = [t.to(card) for t in _layer_args(seed, T, B, C, H, win)]
    frames = args[0].transpose(0, 1).contiguous()  # (B, T, C), as trained
    return frames, args[1:]


def _run(frames, params, win, stride, plain, dhs=None):
    """hs and every gradient of the bidirectional windowed layer: the
    windowed Function forward and reversed."""
    x = frames.clone().requires_grad_(True)
    leaves = [t.clone().requires_grad_(True) for t in params]
    hs = [gru.GRUWindowedFn.apply(x.transpose(0, 1), h, *w, win, stride,
                                  rev, plain)
          for h, w, rev in ((leaves[0], leaves[2:6], False),
                            (leaves[1], leaves[6:], True))]
    if dhs is None:
        g = torch.Generator(device=frames.device).manual_seed(3)
        dhs = [torch.randn(h.shape, generator=g, device=h.device)
               for h in hs]
    torch.autograd.backward(hs, dhs)
    return [h.detach() for h in hs] + [x.grad] + [t.grad for t in leaves], \
        dhs


# the cell's published widths over its longest batch (289 windows of
# 32 x 256 over 1,184 frames, B 64, H 1,024), a ragged shape
@pytest.mark.gpu
@pytest.mark.parametrize("T,B,C,H,win,stride", [
    (1184, 64, 256, 1024, 32, 4), (101, 67, 60, 97, 14, 4)])
def test_bidir_windowed_op_matches_plain_on_the_card(card, T, B, C, H, win,
                                                     stride):
    frames, params = _card_layer(card, 41, T, B, C, H, win)
    gru.reset_launch_counts()
    got, dhs = _run(frames, params, win, stride, plain=False)
    assert gru.LAUNCHES["gru_wfwd"] == 2
    assert gru.LAUNCHES["gru_wbwd"] == 2
    assert got[2].dtype == torch.float32 and got[2].shape == frames.shape
    want, _ = _run(frames, params, win, stride, plain=True, dhs=dhs)
    for g, v in zip(got, want):
        tol = 1e-5 * float(v.abs().max())
        torch.testing.assert_close(g, v, atol=tol, rtol=0)
    again, _ = _run(frames, params, win, stride, plain=False, dhs=dhs)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    # the frames' gradient: each direction's gru_wbwd fold, added
    xb = frames.to(torch.bfloat16).transpose(0, 1)
    hs_f, hs_b = got[:2]
    h0_f, h0_b, *w = params
    dx_f = gru.gru_wbwd_cuda(xb, torch.cat([h0_f[None], hs_f[:-1]]),
                             dhs[0], *w[:4], win, stride, need_dx=True)[0]
    dx_b = gru.gru_wbwd_cuda(xb, torch.cat([hs_b[1:], h0_b[None]]), dhs[1],
                             *w[4:], win, stride, need_dx=True,
                             reverse=True)[0]
    assert torch.equal(got[2], (dx_f + dx_b).transpose(0, 1))
