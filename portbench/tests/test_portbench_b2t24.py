"""The ``b2t24_bigru.train`` cell at a small size on the CPU (sound, it reads
correct; with the reverse direction's frame gradient dropped, the state
left unchanged, half of the batch or the loss altered, it does not; the
loss is limited at the first step, every step's gap reported beside the
limits), its shuffled batches, and the readers ``wbidir_roofline.train``
and ``input_stage_ms.train`` on synthetic records."""

import sys

import numpy as np
import pytest

from portbench import faults
from portbench.core import spec
from portbench.core.peaks import PEAK_FLOPS
from portbench.families import b2t24_bigru_flops, b2t_gru_flops
from portbench.tests import small
from portbench.tests.small import run_small, small_cell
from portbench.tests.test_portbench_spans import (
    PROFILING,
    T0,
    _device,
    _record,
    _span,
    port,  # noqa: F401  (fixture)
)

# the cell's small size, entered into small.py's maps as conftest.py enters
# b2t_gru's: 5 days of 4 trials, shuffled batches of 8 rows of 12-30
# frames of 6 features, windows of 4 every 2, 3 bidirectional layers of 16
small.CONFIG.setdefault("b2t24_bigru", {"in_channels": 6, "hidden": 16,
                                        "n_layers": 3, "n_days": 5,
                                        "win_size": 4, "stride": 2})
small.TRAFFIC.setdefault("train_shuffled", {
    "trials_per_day": 4, "batch_rows": 8, "len_lo": 12, "len_hi": 30,
    "profile_steps": 2})
small.T.setdefault("b2t24_bigru", 30)

CELL = "b2t24_bigru.train"


@pytest.mark.parametrize("trace", [False, True])
def test_sound_small_run_is_correct(trace):
    out = run_small(CELL, trace=trace)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    if trace:
        assert out["breakdown"]["idle_gaps"]


@pytest.mark.parametrize("fault", faults.KINDS["train"])
def test_every_fault_fails(fault):
    fam = spec.family(small_cell(CELL).config)
    with faults.planted(fam, "train", fault):
        out = run_small(CELL)
    assert not out["correct"], out["checks"]


def test_an_altered_loss_is_reported_unlimited():
    """Every checked step's loss gap is reported beside the limits (after
    Adam's updates it reads as high at float32 as in TF32: the bf16 frames
    round apart once the day layers have moved); the first step's is
    limited."""
    fam = spec.family(small_cell(CELL).config)
    assert "loss_gap" not in small_cell(CELL).limits
    with faults.planted(fam, "train", "answer"):
        out = run_small(CELL)
    assert out["notes"]["unlimited"]["loss_gap"] > 9e-4
    first = out["checks"]["first_loss_gap"]
    assert first["value"] > 9e-4 > first["limit"]


def test_dropped_reverse_frame_gradient_fails(monkeypatch):
    """The reversed direction's windowed backward with its frames'
    gradient zeroed: the day layers learn half of what they should."""
    from cross_patient_speech_decoding_tpu_torch.ops import gru

    real = gru.gru_win_backward_plain

    def dropped(*args, reverse=False, **kw):
        out = real(*args, reverse=reverse, **kw)
        if reverse and out[0] is not None:
            out[0].zero_()
        return out

    monkeypatch.setattr(gru, "gru_win_backward_plain", dropped)
    out = run_small(CELL)
    assert not out["correct"], out["checks"]
    assert out["checks"]["grad_norm_gap"]["value"] > \
        out["checks"]["grad_norm_gap"]["limit"]


def test_batches_are_shuffled_over_the_pool_cropped_to_the_longest():
    import torch

    from portbench.loops.train_shuffled import ShuffleFeed

    n_days, trials, T, C, rows = 6, 5, 20, 2, 8
    lengths = np.array([3 + (i * 7) % 17 for i in range(n_days * trials)])
    x = torch.arange(n_days * trials, dtype=torch.float32)[:, None, None] \
        .expand(-1, T, C).contiguous()
    il = torch.as_tensor(lengths, dtype=torch.int32)
    feed = ShuffleFeed((x, il[:, None], il, il), lengths, trials, rows,
                       seed=9)
    seen = []
    for _ in range(4):  # 30 rows: the 4th batch fills from the start
        (xb, _, ilb, _, days), _ = feed.next()
        got = xb[:, 0, 0].long().numpy()
        assert xb.shape == (rows, int(lengths[got].max()), C)
        assert np.array_equal(got // trials, days.numpy())
        assert len(set(got)) == rows
        assert np.array_equal(ilb.numpy(), lengths[got])
        seen.append(got)
    epoch = np.concatenate(seen)
    assert sorted(epoch[:30]) == list(range(30))
    assert np.array_equal(epoch[30:], epoch[:2])
    assert len(set(np.concatenate(seen[:3]) // trials)) > 3


def _rev(reverse):
    return {"reverse": True} if reverse else {}


def _fwd(t, ms, reverse, T=289, B=64, C=256, H=1024, win=32, frames=1184):
    return _span("gru_wfwd", T0 + t, T0 + t + ms / 1e3, device_ms=ms,
                 T=T, B=B, F=win * C, H=H, x_bytes=B * frames * C * 2,
                 need_dx=False, directions=1, route="cuda", **_rev(reverse))


def _bwd(t, ms, reverse, T=289, B=64, C=256, H=1024, win=32, frames=1184,
         need_dx=True):
    fold = {"fold": 8} if need_dx else {}
    return _span("gru_wbwd", T0 + t, T0 + t + ms / 1e3, device_ms=ms,
                 T=T, B=B, F=win * C, H=H, x_bytes=B * frames * C * 2,
                 need_dx=need_dx, directions=1, route="cuda", **fold,
                 **_rev(reverse))


def test_wbidir_roofline_from_known_spans(port):  # noqa: F811
    port.extend([_fwd(0.00, 20.0, False), _fwd(0.02, 20.0, True),
                 _bwd(0.05, 60.0, False), _bwd(0.12, 62.0, True),
                 _bwd(0.19, 30.0, True, need_dx=False)])
    got = spec.reader("wbidir_roofline.train").read(
        _record("train", _device()))
    # by hand at the cell's shape: N = 289 x 64 rows a direction
    N, F, H = 289 * 64, 8192, 1024
    fwd = 2 * (2 * N * 3 * H * H / (PEAK_FLOPS / 3)
               + 2 * N * 3 * H * F / (PEAK_FLOPS / 2))
    for r in port[:2]:
        assert fwd / 2 == pytest.approx(
            b2t24_bigru_flops.wbidir_fwd_least_s(r["attrs"]), rel=1e-9)
    bwd = b2t_gru_flops.frame_grad_least_s(port[2]["attrs"])
    assert got == pytest.approx(100 * (fwd + 2 * bwd) / 0.162, rel=1e-9)
    assert 0 < got < 100


def test_input_stage_ms_per_step(port):  # noqa: F811
    port.extend([_span("augment", T0, T0 + 0.001, step=1, device_ms=0.2),
                 _span("smooth", T0 + 0.002, T0 + 0.003, step=1,
                       device_ms=0.3),
                 _span("day_layer", T0 + 0.004, T0 + 0.005, step=1,
                       device_ms=0.7),
                 _span("day_layer", T0 + 0.05, T0 + 0.052, step=1,
                       device_ms=1.5),
                 _span("augment", T0 + 0.1, T0 + 0.101, step=2,
                       device_ms=0.2),
                 _span("smooth", T0 + 0.102, T0 + 0.103, step=2,
                       device_ms=0.3),
                 _span("day_layer", T0 + 0.11, T0 + 0.112, step=2,
                       device_ms=1.4)])
    got = spec.reader("input_stage_ms.train").read(_record("train",
                                                          _device()))
    assert got == pytest.approx((0.2 + 0.3 + 0.7 + 1.5 + 0.2 + 0.3 + 1.4)
                                / 2)


READERS = ["wbidir_roofline.train", "input_stage_ms.train"]


@pytest.mark.parametrize("metric", READERS)
def test_none_without_spans(port, metric):  # noqa: F811
    rec = _record("train", _device())
    assert spec.reader(metric).read(rec) is None
    # a program without the new op and the new spans: b2t_gru's spans
    port.append(_span("gru_wbwd", T0, T0 + 0.03, device_ms=30.0, T=244,
                      B=64, F=7168, H=768, x_bytes=1, need_dx=True,
                      directions=1, route="cuda", fold=4))
    port.append(_span("day_layer", T0, T0 + 0.001, device_ms=0.7))
    assert spec.reader(metric).read(rec) is None
    port.append(_bwd(0.02, 30.0, True))
    port.append(_span("smooth", T0, T0 + 0.001, device_ms=0.3))
    assert spec.reader(metric).read(_record("train", [])) is None
    assert spec.reader(metric).read(_record("eval", _device())) is None


@pytest.mark.parametrize("metric", READERS)
def test_none_from_a_port_without_spans(monkeypatch, metric):
    monkeypatch.setitem(sys.modules, PROFILING, None)
    assert spec.reader(metric).read(_record("train", _device())) is None
