"""The plain references at a small size on the CPU, against independent
implementations of the same equations (torch's own GRU, optimizer, CTC
decode and scipy's filter)."""

import math

import numpy as np
import pytest
import torch

from portbench.core.weights import draw, sub_seed
from portbench.reference import common
from portbench.tests.small import small_cell

CPU = torch.device("cpu")


def test_gru_matches_torch_gru():
    torch.manual_seed(0)
    T, B, F, H = 7, 3, 5, 4
    x = torch.randn(T, B, F)
    h0 = torch.randn(B, H)
    ref = torch.nn.GRU(F, H)
    wi, wh = ref.weight_ih_l0.detach().t(), ref.weight_hh_l0.detach().t()
    bi, bh = ref.bias_ih_l0.detach(), ref.bias_hh_l0.detach()
    want, _ = ref(x, h0[None])
    got = common.gru(x, h0, wi.contiguous(), bi, wh.contiguous(), bh)
    assert torch.allclose(got, want.detach(), atol=1e-6)
    rev = common.gru(x.flip(0), h0, wi, bi, wh, bh)
    got_r = common.gru(x, h0, wi, bi, wh, bh, reverse=True)
    assert torch.allclose(got_r, rev.flip(0), atol=1e-6)


def test_adamw_matches_torch_adamw():
    torch.manual_seed(1)
    p0 = {"a": torch.randn(4, 3), "b": torch.randn(3)}
    ours = {k: v.clone() for k, v in p0.items()}
    opt = common.AdamW(ours, lr=1e-2, weight_decay=0.1, decay_steps=0)
    theirs = [torch.nn.Parameter(v.clone()) for v in p0.values()]
    topt = torch.optim.AdamW(theirs, lr=1e-2, weight_decay=0.1)
    for _ in range(3):
        g = {k: torch.randn_like(v) for k, v in p0.items()}
        opt.update(g)
        for t, k in zip(theirs, p0):
            t.grad = g[k].clone()
        topt.step()
    for t, k in zip(theirs, p0):
        assert torch.allclose(ours[k], t.detach(), atol=1e-6)


def test_clip_and_schedule():
    p = {"a": torch.zeros(4)}
    opt = common.AdamW(p, lr=1.0, weight_decay=0.0, decay_steps=4,
                       end_factor=0.5, clip=1.0)
    g = opt.update({"a": torch.full((4,), 2.0)})
    assert float(g["a"].norm()) == pytest.approx(1.0)
    assert [opt.factor(k) for k in (0, 2, 4, 9)] == [1.0, 0.75, 0.5, 0.5]


def test_rnn_fig5_eval_decode_and_per():
    cell = small_cell("rnn_fig5.eval")
    from portbench.reference import rnn_fig5 as ref

    cfg = cell.config
    w = draw(ref.leaves(cfg), 5, CPU)
    g = torch.Generator().manual_seed(2)
    B, T, C = 6, 60, cfg["in_channels"]
    x = torch.randn(B, T, C, generator=g)
    labels = torch.randint(1, 10, (B, 7), generator=g, dtype=torch.int32)
    il = torch.full((B,), T, dtype=torch.int32)
    ll = torch.full((B,), 7, dtype=torch.int32)
    out = ref.eval_batch(cfg, w, (x, labels, il, ll))
    # decode by hand from the logits
    best = out["logits"].argmax(-1)
    dists = []
    for b in range(B):
        seq, prev = [], -1
        for s in best[b].tolist():
            if s != 0 and s != prev:
                seq.append(s)
            prev = s
        dists.append(_lev(seq, labels[b].tolist()))
    assert out["per"] == pytest.approx(sum(dists) / (7 * B) * 100)


def _lev(a, b):
    d = list(range(len(b) + 1))
    for i, x in enumerate(a, 1):
        prev, d[0] = d[0], i
        for j, y in enumerate(b, 1):
            prev, d[j] = d[j], min(d[j] + 1, d[j - 1] + 1, prev + (x != y))
    return d[-1]


def test_windows_are_time_major():
    from portbench.reference import rnn_fig5 as ref

    cfg = {"win_size": 3, "stride": 2}
    x = torch.arange(2 * 7 * 2, dtype=torch.float32).reshape(2, 7, 2)
    w = ref.windows(cfg, x)
    assert w.shape == (2, 3, 6)
    assert w[0, 1].tolist() == x[0, 2:5].reshape(-1).tolist()


def test_hg_power_matches_a_sample_loop():
    from scipy.signal import butter

    from portbench.reference import rnn_fig5 as ref

    rng = np.random.default_rng(0)
    chunks = rng.standard_normal((5, 3, 4))
    b, a = butter(2, [0.3, 0.5], btype="band")
    got = ref.hg_power(chunks, b[None], a[None])
    # transposed direct form II by hand, state carried over the bins
    from scipy.signal import lfilter_zi

    z = np.tile(lfilter_zi(b, a), (3, 1))
    want = []
    for chunk in chunks:
        x = chunk - chunk.mean(0)
        ys = []
        for t in range(x.shape[1]):
            y = b[0] * x[:, t] + z[:, 0]
            z = np.concatenate([z[:, 1:], np.zeros((3, 1))], 1) \
                + b[1:] * x[:, t:t + 1] - a[1:] * y[:, None]
            ys.append(y)
        want.append(np.sqrt(np.mean(np.square(ys), axis=0)))
    np.testing.assert_allclose(got, np.array(want), rtol=1e-10)


def test_weights_draw_is_seeded_and_scaled():
    leaves = {"w": ((400, 30), 0.5, 0.0), "s": ((10,), 0.1, 1.0)}
    a = draw(leaves, 7, CPU)
    b = draw(leaves, 7, CPU)
    c = draw(leaves, 8, CPU)
    assert torch.equal(a["w"], b["w"]) and not torch.equal(a["w"], c["w"])
    assert float(a["w"].abs().max()) <= 0.5
    assert float(a["w"].std()) == pytest.approx(0.5 / math.sqrt(3), rel=0.05)
    assert float((a["s"] - 1).abs().max()) <= 0.1
    assert sub_seed(2 ** 40, "x") != sub_seed(2 ** 40, "y")
