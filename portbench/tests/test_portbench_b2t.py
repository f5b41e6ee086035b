"""The ``b2t_gru.train`` cell at a small size on the CPU (sound, it reads
correct; with the frames' gradient dropped, or any fault a train cell can
have, it does not), its day-by-day batches, and the readers
``frame_grad_roofline.train`` and ``day_layer_ms.train`` on synthetic
records."""

import sys

import numpy as np
import pytest

from portbench import faults
from portbench.core import spec
from portbench.core.peaks import PEAK_BYTES, PEAK_FLOPS
from portbench.families import b2t_gru_flops
from portbench.tests.small import run_small, small_cell
from portbench.tests.test_portbench_spans import (
    PROFILING,
    T0,
    _device,
    _record,
    _span,
    port,  # noqa: F401  (fixture)
)

CELL = "b2t_gru.train"


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


def test_dropped_frame_gradient_fails(monkeypatch):
    """The windowed layer's backward with its frames' gradient zeroed:
    the day layers learn nothing, and the gradient norms say so."""
    from cross_patient_speech_decoding_tpu_torch.ops import gru

    real = gru.fold_windows
    monkeypatch.setattr(gru, "fold_windows",
                        lambda *a: real(*a).zero_())
    out = run_small(CELL)
    assert not out["correct"], out["checks"]
    assert out["checks"]["grad_norm_gap"]["value"] > \
        out["checks"]["grad_norm_gap"]["limit"]


def test_batches_take_whole_days_cropped_to_the_longest():
    import torch

    from portbench.loops.train_days import DayFeed

    n_days, trials, T, C = 6, 5, 20, 2
    lengths = np.array([3 + (i * 7) % 17 for i in range(n_days * trials)])
    x = torch.arange(n_days * trials, dtype=torch.float32)[:, None, None] \
        .expand(-1, T, C).contiguous()
    il = torch.as_tensor(lengths, dtype=torch.int32)
    pool = (x, il[:, None], il, il)
    feed = DayFeed(pool, lengths, n_days, trials, 3, 2, seed=9)
    for _ in range(4):
        (xb, _, ilb, _, days), _ = feed.next()
        rows = xb[:, 0, 0].long().numpy()
        assert xb.shape == (6, int(lengths[rows].max()), C)
        assert np.array_equal(rows // trials, days.numpy())
        d = days.numpy()
        assert len(set(d)) == 3 and np.array_equal(d, np.repeat(d[::2], 2))
        assert len(set(rows)) == 6
        assert np.array_equal(ilb.numpy(), lengths[rows])


def _wbwd(t, ms, T=244, B=64, C=512, H=768, win=14, frames=988,
          need_dx=True):
    attrs = dict(T=T, B=B, F=win * C, H=H, x_bytes=B * frames * C * 2,
                 need_dx=need_dx, directions=1, route="cuda")
    if need_dx:
        attrs["fold"] = 4
    return _span("gru_wbwd", T0 + t, T0 + t + ms / 1e3, device_ms=ms,
                 **attrs)


def test_frame_grad_roofline_from_known_spans(port):  # noqa: F811
    port.extend([_wbwd(0.00, 30.0), _wbwd(0.05, 34.0),
                 _wbwd(0.09, 12.0, need_dx=False)])
    got = spec.reader("frame_grad_roofline.train").read(
        _record("train", _device()))
    # by hand at the cell's shape: N = 244 x 64 rows
    N, F, H = 244 * 64, 7168, 768
    f32 = 2 * N * 3 * H * (3 * H + F) + N * F
    bf16 = 2 * N * 3 * H * F * 2
    least = f32 / (PEAK_FLOPS / 3) + bf16 / (PEAK_FLOPS / 2)
    assert least == pytest.approx(b2t_gru_flops.frame_grad_least_s(
        port[0]["attrs"]), rel=1e-9)
    # bound by the products: the bytes, a few GB, take under a ms
    assert 3e9 / PEAK_BYTES < least
    assert got == pytest.approx(100 * 2 * least / 0.064, rel=1e-9)
    assert 0 < got < 100


def test_day_layer_ms_per_step(port):  # noqa: F811
    port.extend([_span("day_layer", T0, T0 + 0.001, step=1, device_ms=0.7),
                 _span("day_layer", T0 + 0.01, T0 + 0.012, step=1,
                       device_ms=1.5),
                 _span("day_layer", T0 + 0.1, T0 + 0.101, step=2,
                       device_ms=0.8),
                 _span("day_layer", T0 + 0.11, T0 + 0.112, step=2,
                       device_ms=1.4)])
    got = spec.reader("day_layer_ms.train").read(_record("train", _device()))
    assert got == pytest.approx((0.7 + 1.5 + 0.8 + 1.4) / 2)


READERS = ["frame_grad_roofline.train", "day_layer_ms.train"]


@pytest.mark.parametrize("metric", READERS)
def test_none_without_spans(port, metric):  # noqa: F811
    rec = _record("train", _device())
    assert spec.reader(metric).read(rec) is None
    # a windowed layer whose frames are data: no span of either
    port.append(_wbwd(0.0, 12.0, need_dx=False))
    assert spec.reader(metric).read(rec) is None
    port.append(_wbwd(0.02, 30.0))
    port.append(_span("day_layer", T0, T0 + 0.001, device_ms=0.7))
    assert spec.reader(metric).read(_record("train", [])) is None
    assert spec.reader(metric).read(_record("eval", _device())) is None


@pytest.mark.parametrize("metric", READERS)
def test_none_from_a_port_without_spans(monkeypatch, metric):
    monkeypatch.setitem(sys.modules, PROFILING, None)
    assert spec.reader(metric).read(_record("train", _device())) is None
