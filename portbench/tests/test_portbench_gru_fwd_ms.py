"""The reader ``gru_fwd_ms.train`` on synthetic records: the device ms of
the forward GRU kernel spans a profiled train step, None without them."""

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

METRIC = "gru_fwd_ms.train"


def test_forward_ms_per_step(port):  # noqa: F811
    """Two steps of fig5's kernel spans (a gru_wfwd of 10 ms and two
    gru_fwd of 9 ms each, then the backward's), a seq2seq gru_bifwd of 6
    ms in a third: the forward spans' ms over the three steps."""
    for step, t0 in ((1, 0.0), (2, 0.3)):
        for r in _fig5_step():
            port.append({**r, "step": step,
                         "start_ns": r["start_ns"] + int(t0 * 1e9),
                         "end_ns": r["end_ns"] + int(t0 * 1e9)})
    port.append(_span("gru_bifwd", T0 + 0.7, T0 + 0.706, step=3,
                      device_ms=6.0))
    rec = _record("train", [("k", T0 - 0.01, T0 + 0.8)])
    got = spec.reader(METRIC).read(rec)
    assert got == pytest.approx((2 * (10.0 + 9.0 + 9.0) + 6.0) / 3)


def test_spans_outside_the_profiled_stretch_are_left_out(port):  # noqa: F811
    port.extend(_fig5_step(fwd_only=True))
    port.append(_span("gru_fwd", T0 + 5.0, T0 + 5.01, step=9,
                      device_ms=50.0))
    got = spec.reader(METRIC).read(_record("train", _device()))
    assert got == pytest.approx(28.0)


def test_none_without_spans(port):  # noqa: F811
    rec = _record("train", _device())
    assert spec.reader(METRIC).read(rec) is None
    # the backward's spans alone, and forward spans without device ms
    port.extend(_fig5_step()[3:])
    port.append(_span("gru_fwd", T0, T0 + 0.01))
    assert spec.reader(METRIC).read(rec) is None
    port.extend(_fig5_step(fwd_only=True))
    assert spec.reader(METRIC).read(_record("train", [])) is None
    assert spec.reader(METRIC).read(_record("eval", _device())) is None


def test_none_from_a_port_without_spans(monkeypatch):
    monkeypatch.setitem(sys.modules, PROFILING, None)
    assert spec.reader(METRIC).read(_record("train", _device())) is None
