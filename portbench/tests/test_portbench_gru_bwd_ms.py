"""The reader ``gru_bwd_ms.train`` on synthetic records: the device ms of
the backward GRU kernel spans a profiled train step, None without them."""

import sys

import pytest

from portbench.core import spec
from portbench.tests.test_portbench_spans import (
    PROFILING,
    T0,
    _device,
    _fig5_step,
    _record,
    _span,
    port,  # noqa: F401  (fixture)
)

METRIC = "gru_bwd_ms.train"


def test_backward_ms_per_step(port):  # noqa: F811
    """Two steps of fig5's kernel spans (two gru_bwd of 20 ms each and a
    gru_wbwd of 18 ms after the forward's), the two gru_bwd of a seq2seq
    encoder's backward (7 ms each) in a third: the backward spans' ms over
    the three steps."""
    for step, t0 in ((1, 0.0), (2, 0.3)):
        for r in _fig5_step():
            port.append({**r, "step": step,
                         "start_ns": r["start_ns"] + int(t0 * 1e9),
                         "end_ns": r["end_ns"] + int(t0 * 1e9)})
    for t0 in (0.7, 0.72):
        port.append(_span("gru_bwd", T0 + t0, T0 + t0 + 0.007, step=3,
                          device_ms=7.0))
    rec = _record("train", [("k", T0 - 0.01, T0 + 0.8)])
    got = spec.reader(METRIC).read(rec)
    assert got == pytest.approx((2 * (20.0 + 20.0 + 18.0) + 14.0) / 3)


def test_spans_outside_the_profiled_stretch_are_left_out(port):  # noqa: F811
    port.extend(_fig5_step())
    port.append(_span("gru_bwd", T0 + 5.0, T0 + 5.01, step=9,
                      device_ms=50.0))
    got = spec.reader(METRIC).read(_record("train", _device()))
    assert got == pytest.approx(58.0)


def test_none_without_spans(port):  # noqa: F811
    rec = _record("train", _device())
    assert spec.reader(METRIC).read(rec) is None
    # the forward's spans alone, and backward spans without device ms
    port.extend(_fig5_step(fwd_only=True))
    port.append(_span("gru_bwd", T0, T0 + 0.01))
    assert spec.reader(METRIC).read(rec) is None
    port.extend(_fig5_step()[3:])
    assert spec.reader(METRIC).read(_record("train", [])) is None
    assert spec.reader(METRIC).read(_record("eval", _device())) is None


def test_none_from_a_port_without_spans(monkeypatch):
    monkeypatch.setitem(sys.modules, PROFILING, None)
    assert spec.reader(METRIC).read(_record("train", _device())) is None
