"""The readers of the port's spans (``gru_roofline.*``, ``step_idle.train``,
``decode_idle.eval``) on synthetic records: known shapes give the
roofline the module spans' reduction gives for the same work, the idle
inside the step lies within the whole stretch's idle, and a port that
keeps no spans gives None."""

import sys

import pytest

from portbench.core import reduce, spec
from portbench.core.peaks import least_seconds

PROFILING = "cross_patient_speech_decoding_tpu_torch.utils.profiling"
T0 = 1.7e9  # seconds on the profiler's clock
# float64 seconds near T0 resolve 0.24 us: idle shares of a 40-50 ms
# stretch agree to about 1e-5 of their value
REL = 1e-4


def _span(name, start_s, end_s, step=1, device_ms=None, **attrs):
    return {"name": name, "id": 0, "parent": None, "step": step,
            "thread": 0, "start_ns": int(round(start_s * 1e9)),
            "end_ns": int(round(end_s * 1e9)), "attrs": attrs,
            "device_ms": device_ms}


@pytest.fixture
def port(monkeypatch):
    """Set the records the port's ``spans()`` returns."""
    import importlib

    mod = importlib.import_module(PROFILING)
    held = []
    monkeypatch.setattr(mod, "spans", lambda: list(held))
    return held


def _gru(name, t, ms, T, B, F, H, x_bytes=None, need_dx=True, dirs=1):
    return _span(name, T0 + t, T0 + t + ms / 1e3, device_ms=ms, T=T, B=B,
                 F=F, H=H, x_bytes=T * B * F * 4 if x_bytes is None
                 else x_bytes, need_dx=need_dx, directions=dirs,
                 route="cuda")


def _record(kind, device, window_s=1.0, **extra):
    return {"kind": kind, "device": device, "window_s": window_s,
            "busy_s": 0.0, **extra}


def _fig5_step(rows=512, T=600, C=60, win=14, stride=4, H=512,
               fwd_only=False):
    n = (T - win) // stride + 1
    frames = rows * T * C * 2
    spans = [_gru("gru_wfwd", 0.00, 10.0, n, rows, win * C, H,
                  x_bytes=frames, need_dx=False),
             _gru("gru_fwd", 0.02, 9.0, n, rows, H, H),
             _gru("gru_fwd", 0.04, 9.0, n, rows, H, H)]
    if not fwd_only:
        spans += [_gru("gru_bwd", 0.06, 20.0, n, rows, H, H),
                  _gru("gru_bwd", 0.09, 20.0, n, rows, H, H),
                  _gru("gru_wbwd", 0.12, 18.0, n, rows, win * C, H,
                       x_bytes=frames, need_dx=False)]
    return spans


def _device():
    return [("k", T0 - 0.01, T0 + 0.2)]


def test_fig5_spans_read_the_module_spans_work(port):
    cfg = spec.load_cell("rnn_fig5.train").config
    tr = spec.load_cell("rnn_fig5.train").traffic
    fam = spec.family(cfg)
    port.extend(_fig5_step())
    ms = sum(s["device_ms"] for s in port)
    rec = _record("train", _device(), spans=[("rnn", "fwd", 28.0),
                                             ("rnn", "bwd", ms - 28.0)],
                  span_work=fam.span_work(cfg, tr, 512))
    got = spec.reader("gru_roofline.train").read(rec)
    want = reduce.roofline(rec, "train")
    assert got == pytest.approx(want, rel=1e-9)
    assert 0 < got < 100


def test_seq2seq_spans_read_the_module_spans_work(port):
    cfg = spec.load_cell("seq2seq_ref.train").config
    tr = spec.load_cell("seq2seq_ref.train").traffic
    fam = spec.family(cfg)
    rows, H, F = 1224, cfg["hidden"], cfg["n_filters"]
    Tc = tr["T"] - cfg["kernel_size"] + 1
    port.append(_gru("gru_bifwd", 0.0, 30.0, Tc, rows, F, H, dirs=2))
    port.extend(_gru("gru_fwd", 0.03 + 0.001 * i, 0.5, 1, rows, H, H)
                for i in range(3))
    port.extend(_gru("gru_bwd", 0.04 + 0.001 * i, 0.6, 1, rows, H, H)
                for i in range(3))
    port.extend(_gru("gru_bwd", 0.05 + 0.03 * i, 30.0, Tc, rows, F, H)
                for i in range(2))
    work = fam.span_work(cfg, tr, rows)
    least = (least_seconds(*work[("encoder.rnn", "fwd")])
             + least_seconds(*work[("encoder.rnn", "bwd")])
             + 3 * least_seconds(*work[("decoder.rnn", "fwd")])
             + 3 * least_seconds(*work[("decoder.rnn", "bwd")]))
    spent = sum(s["device_ms"] for s in port) / 1e3
    got = spec.reader("gru_roofline.train").read(_record("train", _device()))
    assert got == pytest.approx(100 * least / spent, rel=1e-9)


def test_eval_roofline_reads_forward_spans_only(port):
    port.extend(_fig5_step())
    fwd = spec.reader("gru_roofline.eval").read(_record("eval", _device()))
    port[:] = _fig5_step(fwd_only=True)
    assert spec.reader("gru_roofline.eval").read(
        _record("eval", _device())) == pytest.approx(fwd, rel=1e-12)
    assert spec.reader("gru_roofline.eval").read(
        _record("train", _device())) is None


def test_spans_outside_the_profiled_stretch_are_left_out(port):
    port.extend(_fig5_step())
    inside = spec.reader("gru_roofline.train").read(
        _record("train", _device()))
    early = _gru("gru_fwd", -50.0, 1.0, 147, 512, 512, 512)
    port.append(early)
    assert spec.reader("gru_roofline.train").read(
        _record("train", _device())) == inside


def test_step_idle_lies_within_device_idle(port):
    # device work: [0, 10) and [14, 20) and [30, 40) ms of a 50 ms stretch
    dev = [("k", T0 + a / 1e3, T0 + b / 1e3)
           for a, b in ((0, 10), (14, 20), (30, 40))]
    lo, hi = T0, T0 + 0.05
    port.extend([_span("train_step", T0 + 0.002, T0 + 0.022),
                 _span("forward", T0 + 0.003, T0 + 0.008),
                 _span("train_step", T0 + 0.028, T0 + 0.041, step=2)])
    from portbench.core.stats import covered

    rec = _record("train", dev, window_s=hi - lo,
                  busy_s=covered([(s, e) for _, s, e in dev], lo, hi))
    step_idle = spec.reader("step_idle.train").read(rec)
    # idle inside the steps: 12-14 and 20-22, then 28-30 and 40-41 ms
    assert step_idle == pytest.approx(100 * 9e-3 / 0.05, rel=REL)
    device_idle = spec.reader("device_idle.train").read(rec)
    assert device_idle == pytest.approx(100 * 24e-3 / 0.05, rel=REL)
    assert step_idle <= device_idle


def test_decode_idle_reads_decode_and_per(port):
    dev = [("k", T0, T0 + 0.010), ("k", T0 + 0.030, T0 + 0.040)]
    port.extend([_span("eval_step", T0, T0 + 0.040),
                 _span("decode", T0 + 0.008, T0 + 0.016),
                 _span("per", T0 + 0.016, T0 + 0.032)])
    rec = _record("eval", dev, window_s=0.04)
    assert spec.reader("decode_idle.eval").read(rec) == \
        pytest.approx(100 * 20e-3 / 0.04, rel=REL)
    assert spec.reader("decode_idle.eval").read(
        _record("train", dev, window_s=0.04)) is None


READERS = ["gru_roofline.train", "gru_roofline.eval", "step_idle.train",
           "decode_idle.eval"]


@pytest.mark.parametrize("metric", READERS)
@pytest.mark.parametrize("kind", ["train", "eval"])
def test_none_without_spans(port, metric, kind):
    assert spec.reader(metric).read(_record(kind, _device())) is None
    port.extend(_fig5_step())
    port.append(_span("train_step", T0, T0 + 0.1))
    assert spec.reader(metric).read(_record(kind, [])) is None


@pytest.mark.parametrize("metric", READERS)
def test_none_from_a_port_without_spans(monkeypatch, metric):
    monkeypatch.setitem(sys.modules, PROFILING, None)
    kind = metric.rsplit(".", 1)[1]
    assert spec.reader(metric).read(_record(kind, _device())) is None
