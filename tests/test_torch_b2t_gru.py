"""The brain-to-text GRU decoder (``models/b2t_gru.py``) and the frames'
gradient out of the windowed GRU layer, against the benchmark's plain
reference (``portbench/reference/b2t_gru.py``) and autograd.

CPU cases, at a small size (C 6, window 3, stride 2, H 16, 3 layers, 5
days, B 8, unequal lengths), with seeded random weights; the port runs its
plain GRU versions. Tolerances, each from what differs between the two
sides: the port sums the day layer per day (``addmm``) where the
reference gathers and ``einsum``s, materialises windows by ``unfold``
where the reference does, and sums gradients over time and batch in
another order, all in float32 over at most a few hundred terms, so a
tensor agrees to GRAD_RTOL x its largest value; the logits and the loss go
through the same products with no reduction over the batch: LOGIT_ATOL.

Card cases (``gpu``; they skip without a card, and run there with
``python -m pytest tests/test_torch_b2t_gru.py --noconftest -m gpu``):
``gru_wbwd`` with the frames' gradient against its plain version at the
cell's shape, a ragged one and fig_5's, two runs bitwise equal, and
``need_dx`` changing no other output.
"""

import numpy as np
import pytest
import torch

from cross_patient_speech_decoding_tpu_torch.models import (
    BrainToTextGRU,
    DayAffine,
)
from cross_patient_speech_decoding_tpu_torch.models.layers import day_groups
from cross_patient_speech_decoding_tpu_torch.ops import gru
from cross_patient_speech_decoding_tpu_torch.train import (
    create_train_state,
    make_ctc_train_step,
    make_optimizer,
)
from portbench.core.weights import draw, load_into
from portbench.reference import b2t_gru as ref

GRAD_RTOL = 2e-5
LOGIT_ATOL = 2e-5

CFG = {"in_channels": 6, "n_days": 5, "hidden": 16, "n_layers": 3,
       "n_classes": 7, "blank": 0, "win_size": 3, "stride": 2,
       "input_dropout": 0.2, "dropout": 0.4, "betas": [0.9, 0.999],
       "optimizer": {"lr": 0.005, "weight_decay": 0.001, "decay_steps": 6,
                     "eps": 0.1, "warmup_steps": 2, "schedule": "cosine",
                     "min_lr": 0.0001, "clip": 10.0, "no_decay": ["day."]}}
CPU = torch.device("cpu")


def _close(got, want, rtol=GRAD_RTOL):
    tol = rtol * float(want.abs().max())
    torch.testing.assert_close(got, want, atol=tol, rtol=0)


def _model(seed=3, cfg=CFG):
    m = BrainToTextGRU(cfg["in_channels"], cfg["hidden"], cfg["n_layers"],
                       cfg["n_classes"], n_days=cfg["n_days"],
                       input_dropout=cfg["input_dropout"],
                       dropout=cfg["dropout"], win_size=cfg["win_size"],
                       stride=cfg["stride"], device="cpu")
    w = draw(ref.leaves(cfg), seed, CPU)
    load_into(m, w)
    return m, w


def _batch(seed=0, B=8, T=24, days=(0, 0, 3, 3, 1, 1, 3, 2)):
    g = torch.Generator().manual_seed(seed)
    il = torch.tensor([24, 19, 15, 24, 11, 20, 22, 14], dtype=torch.int32)
    x = torch.randn(B, T, CFG["in_channels"], generator=g)
    x[torch.arange(T)[None, :] >= il[:, None]] = 0.0
    ll = torch.tensor([3, 2, 2, 4, 1, 3, 2, 2], dtype=torch.int32)
    labels = torch.randint(1, CFG["n_classes"], (B, 4), generator=g,
                           dtype=torch.int32)
    return x, labels, il, ll, torch.tensor(days)


# ---------------------------------------------------------------------------
# the windowed layer's frame gradient
# ---------------------------------------------------------------------------


def _win_args(seed, T, B, C, H, win):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(T, B, C, generator=g)
    h0 = torch.randn(B, H, generator=g) * 0.3
    wi = torch.randn(win * C, 3 * H, generator=g) / (win * C) ** 0.5
    wh = torch.randn(H, 3 * H, generator=g) / H ** 0.5
    bi = torch.randn(3 * H, generator=g) * 0.1
    bh = torch.randn(3 * H, generator=g) * 0.1
    return x, h0, wi, bi, wh, bh


@pytest.mark.parametrize("win,stride,T", [(3, 2, 11), (3, 2, 12), (4, 4, 16),
                                          (6, 2, 27), (7, 3, 23),
                                          (14, 4, 33)])
def test_win_backward_dx_matches_autograd(win, stride, T):
    """``gru_win_backward_plain``'s dx against autograd through ``unfold``
    and ``gru_layer_plain``; the other outputs as before."""
    B, C, H = 5, 3, 8
    x, h0, wi, bi, wh, bh = _win_args(1, T, B, C, H, win)
    n_win = gru.n_windows(T, win, stride)
    dhs = torch.randn(n_win, B, H, generator=torch.Generator().manual_seed(2))
    leaves = [t.clone().requires_grad_(True) for t in (x, h0, wi, bi, wh,
                                                       bh)]
    xw = gru.reformat_time_windows(leaves[0].transpose(0, 1), win, stride)
    hs = gru.gru_layer_plain(xw.transpose(0, 1), *leaves[1:])
    hs.backward(dhs)
    hprev = torch.cat([h0[None], hs.detach()[:-1]])
    dx, dh0, dwi, dwh, dbi, dbh = gru.gru_win_backward_plain(
        x, hprev, dhs, wi, bi, wh, bh, win, stride, need_dx=True)
    for got, leaf in zip((dx, dh0, dwi, dbi, dwh, dbh), leaves):
        _close(got, leaf.grad)
    # frames after the last window get 0
    assert torch.equal(dx[(n_win - 1) * stride + win:],
                       torch.zeros_like(dx[(n_win - 1) * stride + win:]))
    none = gru.gru_win_backward_plain(x, hprev, dhs, wi, bi, wh, bh, win,
                                      stride)
    assert none[0] is None
    assert all(torch.equal(a, b) for a, b in zip(none[1:], (dh0, dwi, dwh,
                                                             dbi, dbh)))


def test_fold_sums_each_frames_windows_in_order():
    # 3 windows of 3 frames every 2 over 8 frames, C 1, B 1: window k is
    # 10^k at each of its rows
    dxw = torch.tensor([[[1.0, 1.0, 1.0]], [[10.0, 10.0, 10.0]],
                        [[100.0, 100.0, 100.0]]])
    got = gru.fold_windows(dxw, 8, 3, 2)[:, 0, 0].tolist()
    assert got == [1.0, 1.0, 11.0, 10.0, 110.0, 100.0, 100.0, 0.0]


@pytest.mark.parametrize("plain_route", [True, False])
def test_windowed_layer_frames_gradient_is_straight_through(monkeypatch,
                                                            plain_route):
    """``gru_layer_windowed`` reads frames that require a gradient in bf16
    and returns their gradient in float32, unrounded: the reference's
    straight-through rounding; on the kernels' route (its wrappers here
    replaced by the plain versions) as on the CPU's."""
    if not plain_route:
        monkeypatch.setattr(gru, "_route", lambda x: "cuda")
        monkeypatch.setattr(gru, "_batch_major", lambda x: x)
        monkeypatch.setattr(gru, "gru_wfwd_cuda",
                            gru.gru_layer_windowed_plain)
        monkeypatch.setattr(gru, "gru_wbwd_cuda", gru.gru_win_backward_plain)
    T, B, C, H, win, stride = 21, 4, 5, 8, 3, 2
    x, h0, wi, bi, wh, bh = _win_args(7, T, B, C, H, win)
    dhs = torch.randn(gru.n_windows(T, win, stride), B, H,
                      generator=torch.Generator().manual_seed(8))
    xp = x.transpose(0, 1).contiguous().requires_grad_(True)  # (B, T, C)
    hs = gru.gru_layer_windowed(xp.transpose(0, 1), h0, wi, bi, wh, bh, win,
                                stride)
    hs.backward(dhs)
    assert xp.grad.dtype == torch.float32
    xr = xp.detach().clone().requires_grad_(True)
    cfg = {"win_size": win, "stride": stride}
    want = ref.gru(ref.patches(cfg, xr).transpose(0, 1), h0, wi, bi, wh, bh)
    _close(hs.detach(), want.detach(), rtol=LOGIT_ATOL)
    want.backward(dhs)
    _close(xp.grad, xr.grad)
    # a gradient rounded to bf16 would sit on the bf16 grid
    assert not torch.equal(xp.grad, xp.grad.to(torch.bfloat16).float())


def test_data_frames_keep_the_realtime_path():
    """Frames that need no gradient are read as given, bf16 here, and the
    backward forms no dx (RealtimeRNN's path); float32 frames that need a
    gradient are rounded inside the op to the same hs, bit for bit."""
    T, B, C, H, win, stride = 20, 3, 4, 8, 3, 2
    x, h0, *w = _win_args(9, T, B, C, H, win)
    w = [t.requires_grad_(True) for t in w]
    a = gru.gru_layer_windowed(x.to(torch.bfloat16), h0, *w, win, stride)
    b = gru.gru_layer_windowed(x.clone().requires_grad_(True), h0, *w, win,
                               stride)
    assert torch.equal(a, b)
    seen = {}
    real = gru.gru_win_backward_plain

    def spy(*args, **kw):
        seen.update(kw)
        return real(*args, **kw)

    gru.gru_win_backward_plain = spy
    try:
        a.sum().backward()
    finally:
        gru.gru_win_backward_plain = real
    assert seen == {"need_dx": False, "reverse": False}


# ---------------------------------------------------------------------------
# the day layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("days,want", [
    ([2, 2, 0, 0, 0, 4], [(2, slice(0, 2)), (0, slice(2, 5)),
                          (4, slice(5, 6))]),
    ([1, 3, 1, 3], [(1, [0, 2]), (3, [1, 3])]),
])
def test_day_groups(days, want):
    assert day_groups(torch.tensor(days), len(days)) == want


@pytest.mark.parametrize("days", [(0, 0, 3, 3, 1, 1, 3, 2),
                                  (4, 1, 4, 1, 0, 4, 2, 2)])
def test_day_affine_matches_the_gather(days):
    """Forward and every gradient (frames, the days present, 0 for the
    others) against the published gather and einsum."""
    torch.manual_seed(0)
    layer = DayAffine(5, 6)
    with torch.no_grad():
        layer.w.add_(torch.randn_like(layer.w) * 0.3)
        layer.b.add_(torch.randn_like(layer.b) * 0.1)
    x = torch.randn(8, 7, 6, requires_grad=True)
    d = torch.tensor(days)
    y = layer(x, d)
    p = {"day.w": layer.w.detach().clone().requires_grad_(True),
         "day.b": layer.b.detach().clone().requires_grad_(True)}
    xr = x.detach().clone().requires_grad_(True)
    want = ref.day_layer(p, xr, d)
    _close(y.detach(), want.detach(), rtol=LOGIT_ATOL)
    dy = torch.randn_like(y)
    y.backward(dy)
    want.backward(dy)
    _close(x.grad, xr.grad)
    _close(layer.w.grad, p["day.w"].grad)
    _close(layer.b.grad, p["day.b"].grad)
    absent = sorted(set(range(5)) - set(days))
    assert not layer.w.grad[absent].any() and not layer.b.grad[absent].any()


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
    _close(got, want, rtol=LOGIT_ATOL)


def test_loss_and_every_gradient_match_the_reference():
    """In training (both dropouts on, masks from one seed in the port's
    order): the loss and the gradient of every weight and of the input
    frames."""
    m, w = _model()
    x, labels, il, ll, days = _batch()
    from cross_patient_speech_decoding_tpu_torch.ops.ctc import (
        ctc_loss_mean,
    )
    from cross_patient_speech_decoding_tpu_torch.models.realtime_rnn import (
        adjusted_input_lengths,
    )

    m.train()
    xp = x.clone().requires_grad_(True)
    logits = m(xp, days, generator=torch.Generator().manual_seed(5))
    loss = ctc_loss_mean(logits, adjusted_input_lengths(il, 3, 2), labels,
                         ll, 0)
    loss.backward()
    p = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    xr = x.clone().requires_grad_(True)
    want = ref.ctc_loss(CFG, ref.forward(CFG, p, xr, days,
                                         torch.Generator().manual_seed(5)),
                        labels, il, ll)
    want.backward()
    assert float(loss.detach()) == pytest.approx(float(want.detach()),
                                         rel=LOGIT_ATOL)
    grads = dict(m.named_parameters())
    assert set(grads) == set(p)
    for name, leaf in p.items():
        _close(grads[name].grad, leaf.grad)
    _close(xp.grad, xr.grad)
    assert xp.grad.abs().max() > 0


@pytest.mark.parametrize("steps", [1, 3, 8])
def test_adamw_matches_the_reference(steps):
    """The port's AdamW with the no-decay group, the warm-up and the
    cosine (to step 8, past ``decay_steps`` 6) against the reference's, on
    the same gradients; the schedule's factors by hand."""
    m, w = _model()
    tx = make_optimizer(**CFG["optimizer"])
    state = create_train_state(m, tx)
    assert [g["weight_decay"] for g in state.optimizer.param_groups] == \
        [0.001, 0.0]
    p = {k: v.clone() for k, v in w.items()}
    opt = ref.AdamW(p, betas=(0.9, 0.999), **CFG["optimizer"])
    g = torch.Generator().manual_seed(11)
    for _ in range(steps):
        grads = {k: torch.randn(v.shape, generator=g) * 0.05
                 for k, v in w.items()}
        for name, q in m.named_parameters():
            q.grad = grads[name].clone()
        state.optimizer.step()
        state.schedule.step()
        opt.update(grads)
    for name, q in m.named_parameters():
        _close(q.detach() - w[name], p[name] - w[name])
    r = 0.0001 / 0.005
    assert [tx.factor(k) for k in (0, 1, 2, 6, 9)] == pytest.approx(
        [0.0, 0.5, 1.0, r, r])
    assert tx.factor(4) == pytest.approx(r + (1 - r) * 0.5)


def test_three_train_steps_match_the_reference():
    """``make_ctc_train_step`` on (x, labels, input lengths, label lengths,
    days) batches, dropout on: each step's loss, the first step's
    gradients as AdamW took them, the weights after three updates."""
    m, w = _model()
    tx = make_optimizer(**CFG["optimizer"])
    state = create_train_state(m, tx)
    step = make_ctc_train_step(m, tx)
    batches = [_batch(s, days=d) for s, d in
               ((0, (0, 0, 3, 3, 1, 1, 3, 2)), (1, (4, 4, 4, 2, 2, 2, 1, 1)),
                (2, (1, 3, 1, 3, 0, 0, 2, 2)))]
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
    assert state.step == 3


def test_four_entry_batches_keep_their_step():
    """A RealtimeRNN's four-entry batch trains as before: no days, no
    frame counters."""
    from cross_patient_speech_decoding_tpu_torch.models import RealtimeRNN
    from cross_patient_speech_decoding_tpu_torch.utils import profiling

    m = RealtimeRNN(4, 8, 2, 5, win_size=3, stride=2, device="cpu")
    tx = make_optimizer(1e-3, 0.0, 10)
    x, labels, il, ll, _ = _batch()
    batch = (x[..., :4], labels % 5, il, ll)
    profiling.reset()
    with profiling.recording():
        make_ctc_train_step(m, tx)(create_train_state(m, tx), batch)
    root = next(r for r in profiling.spans() if r["name"] == "train_step")
    assert root["attrs"] == {"rows": 8}
    profiling.reset()
    m2, _ = _model()
    with profiling.recording():
        make_ctc_train_step(m2, tx)(create_train_state(m2, tx), _batch())
    recs = profiling.spans()
    root = next(r for r in recs if r["name"] == "train_step")
    assert root["attrs"] == {"rows": 8, "frames": 8 * 24}
    day = [r for r in recs if r["name"] == "day_layer"]
    assert len(day) == 2 and all(
        r["attrs"] == {"rows": 8, "days": 4, "T": 24, "C": 6,
                       "path": "sorted"} for r in day)
    wb = next(r for r in recs if r["name"] == "gru_wbwd")
    assert wb["attrs"]["need_dx"] is True and wb["attrs"]["fold"] == 2
    profiling.reset()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _card_args(card, seed, T, B, C, H, win, stride):
    rng = np.random.default_rng(seed)
    n_win = gru.n_windows(T, win, stride)
    F = win * C
    arrs = [rng.normal(size=(B, T, C)) * 0.5,
            rng.normal(size=(n_win, B, H)) * 0.3,
            rng.normal(size=(n_win, B, H)),
            rng.normal(size=(F, 3 * H)) / np.sqrt(F),
            rng.normal(size=(3 * H,)) * 0.1,
            rng.normal(size=(H, 3 * H)) / np.sqrt(H),
            rng.normal(size=(3 * H,)) * 0.1]
    x, hprev, dhs, *w = [torch.as_tensor(a, dtype=torch.float32,
                                         device=card) for a in arrs]
    return x.to(torch.bfloat16).transpose(0, 1), hprev, dhs, w


# the cell's mean padded shape, a ragged one ((T - 14) % 4 != 0, B off the
# 128-row tiles, C off 16-byte runs of bf16), fig_5's
@pytest.mark.gpu
@pytest.mark.parametrize("T,B,C,H", [(988, 64, 512, 768), (101, 67, 60, 97),
                                     (39, 3, 5, 16), (600, 512, 60, 512)])
def test_gru_wbwd_frames_gradient_matches_plain(card, T, B, C, H):
    win, stride = 14, 4
    x, hprev, dhs, w = _card_args(card, 31, T, B, C, H, win, stride)
    gru.reset_launch_counts()
    got = gru.gru_wbwd_cuda(x, hprev, dhs, *w, win, stride, need_dx=True)
    assert gru.LAUNCHES["gru_wbwd"] == 1
    want = gru.gru_win_backward_plain(x, hprev, dhs, *w, win, stride,
                                      need_dx=True)
    assert got[0].shape == (T, B, C) and got[0].dtype == torch.float32
    for g, v in zip(got, want):
        tol = 1e-5 * float(v.abs().max())
        torch.testing.assert_close(g, v, atol=tol, rtol=0)
    # fixed partials and a fixed fold order: the same bits again
    again = gru.gru_wbwd_cuda(x, hprev, dhs, *w, win, stride, need_dx=True)
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    # the frames' gradient changes no other output
    no_dx = gru.gru_wbwd_cuda(x, hprev, dhs, *w, win, stride)
    assert no_dx[0] is None
    assert all(torch.equal(a, b) for a, b in zip(no_dx[1:], got[1:]))


@pytest.mark.gpu
@pytest.mark.parametrize("T,B,C,H", [(63, 9, 16, 32), (988, 64, 512, 768)])
def test_fold_kernel_is_the_plain_fold_bit_for_bit(card, T, B, C, H):
    """The windowed backward's frames' gradient is, bit for bit, the plain
    fold of the windows' gradient that ``gru_bwd`` forms over the same
    windows materialised: the same products, then the same adds in the
    same order."""
    win, stride = 14, 4
    x, hprev, dhs, w = _card_args(card, 32, T, B, C, H, win, stride)
    got = gru.gru_wbwd_cuda(x, hprev, dhs, *w, win, stride, need_dx=True)
    xw = gru.reformat_time_windows(x.transpose(0, 1), win, stride)
    dxw = gru.gru_bwd_cuda(xw.transpose(0, 1).contiguous(), hprev, dhs, *w,
                           need_dx=True)[0]
    assert torch.equal(got[0], gru.fold_windows(dxw, T, win, stride))


def test_kernel_spans_equal_the_launches(monkeypatch):
    """A ``BrainToTextGRU`` train step down the kernels' route (the
    wrappers replaced by counted plain versions): one kernel span a
    ``LAUNCHES`` count, the windowed backward's with the frames'
    gradient."""
    from collections import Counter

    from cross_patient_speech_decoding_tpu_torch.utils import profiling

    def counted(name, plain):
        def launch(*args, **kw):
            gru.LAUNCHES[name] += 1
            return plain(*args, **kw)
        return launch

    monkeypatch.setattr(gru, "product_counts",
                        lambda: {"wgmma": 0, "mma_sync": 0})
    monkeypatch.setattr(gru, "_route", lambda x: "cuda")
    monkeypatch.setattr(gru, "_batch_major", lambda x: x)
    for name, plain in (("gru_fwd", gru.gru_layer_plain),
                        ("gru_wfwd", gru.gru_layer_windowed_plain),
                        ("gru_bwd", gru.gru_backward_plain),
                        ("gru_wbwd", gru.gru_win_backward_plain)):
        monkeypatch.setattr(gru, f"{name}_cuda", counted(name, plain))
    m, _ = _model()
    tx = make_optimizer(**CFG["optimizer"])
    gru.reset_launch_counts()
    profiling.reset()
    with profiling.recording():
        make_ctc_train_step(m, tx)(create_train_state(m, tx), _batch())
    recs = profiling.spans()
    profiling.reset()
    got = Counter(r["name"] for r in recs if r["name"] in gru.LAUNCHES)
    assert got == Counter({k: v for k, v in gru.LAUNCHES.items() if v})
    assert got == {"gru_wfwd": 1, "gru_fwd": 2, "gru_bwd": 2, "gru_wbwd": 1}
    wb = next(r for r in recs if r["name"] == "gru_wbwd")
    assert wb["attrs"]["need_dx"] is True and wb["attrs"]["route"] == "cuda"
