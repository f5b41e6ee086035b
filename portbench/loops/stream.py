"""Open-loop streaming: one patient's raw signal arrives on the host a bin
at a time at the signal's own rate, and each bin goes through the port's
realtime step (DSP, ring, a GRU step every ``stride`` bins, greedy
emission) until its result is on the host.

A bin's latency runs from when it was due to when its emission is on the
host, so a stall counts against every bin queued behind it; the window's
99th percentile is the end-to-end metric. ``correct``
compares every bin of the window: the power the port fed its ring, the
logits of each GRU step, and each emission where the reference's argmax
at that step and the one before is decided.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.core import compare
from portbench.core.stats import covered, tail
from portbench.core.trace import (ModuleSpans, idle_gaps, profiled, ranges,
                                  top_ops)
from portbench.core.weights import draw, sub_seed
from portbench.loops.train import mark, now


# tails printed on the line before the result, beside the end-to-end one
TAILS = {"p50": 0.5, "p90": 0.9, "p95": 0.95, "p999": 0.999}
# the last stretch before a bin is due is spun, not slept: a sleep can
# overshoot by more than a millisecond on a busy host, and the overshoot
# would count in the bin's latency
SPIN_S = 0.003


def wait_until(t: float) -> None:
    d = t - now()
    if d > SPIN_S:
        time.sleep(d - SPIN_S)
    while now() < t:
        pass


def coefficients(traffic: dict):
    """(b, a) of each band's Butterworth filter, (bands, taps) float64."""
    from scipy.signal import butter

    bs, as_ = zip(*(butter(traffic["filter_order"], band, btype="band")
                    for band in traffic["bands"]))
    return np.stack(bs), np.stack(as_)


def setup(run) -> None:
    cfg, tr, dev = run.cfg, run.traffic, run.device
    run.period = tr["bin_ms"] / 1e3
    run.n_bins = int(round(run.seconds / run.period))
    n_warm = int(tr["warm_bins"])
    run.weights = draw(run.ref.leaves(cfg), run.seed, dev)
    mark(run, "weights")
    run.model = run.fam.build(cfg, run.weights, dev)
    run.model.eval()
    mark(run, "model")
    run.b_np, run.a_np = coefficients(tr)
    run.b = torch.as_tensor(run.b_np, dtype=torch.float32, device=dev)
    run.a = torch.as_tensor(run.a_np, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(sub_seed(run.seed, "signal"))
    sig = rng.standard_normal(
        (n_warm + run.n_bins, cfg["in_channels"], int(tr["samples_per_bin"])),
        dtype=np.float32)
    run.signal = sig[n_warm:]
    chunks = torch.from_numpy(sig)
    run.chunks = chunks.pin_memory() if dev.type == "cuda" else chunks
    mark(run, "inputs")
    run.rt_step, fresh = run.fam.stream_parts(cfg, run.model, run.b_np,
                                              run.a_np)
    warm = fresh()
    run.fam.reset_launch_counts()
    for k in range(n_warm):
        warm, out = run.rt_step(warm, run.chunks[k].to(dev), run.b, run.a)
        int(out[0])
    run.note(launches_warm_bins={"bins": n_warm,
                                 **run.fam.launch_counts()})
    run.state = fresh()
    run.n_warm = n_warm
    run.lat, run.late, run.syms, run.gru = [], [], [], {}
    # each bin's power is copied into one buffer made now, so that the
    # window holds no ring alive and allocates no device memory for it
    run.powers = torch.empty((run.n_bins, cfg["in_channels"]),
                             dtype=torch.float32, device=dev)
    mark(run, "warm_bins")


def _bins(run, t0: float, lo: int, hi: int, label: str | None = None):
    dev = run.device
    for k in range(lo, hi):
        due = t0 + k * run.period
        wait_until(due)
        t_take = now()
        ctx = torch.profiler.record_function(label) if label else None
        if ctx:
            ctx.__enter__()
        chunk = run.chunks[run.n_warm + k].to(dev, non_blocking=True)
        run.state, (e, lg, ran) = run.rt_step(run.state, chunk, run.b,
                                              run.a)
        sym = int(e)
        if ctx:
            ctx.__exit__(None, None, None)
        t_done = now()
        run.lat.append(t_done - due)
        run.late.append(t_take - due)
        run.syms.append(sym)
        run.powers[k].copy_(run.state.ring[-1])
        if ran:
            run.gru[k] = lg


def _lateness(run) -> dict:
    ms = [v * 1e3 for v in run.late]
    return {"generator_late_ms_p50": tail(ms, 0.5),
            "generator_late_ms_p99": tail(ms, 0.99),
            "generator_late_ms_max": max(ms)}


def window(run, seconds: float) -> dict:
    t0 = now() + 0.01
    _bins(run, t0, 0, run.n_bins)
    run.attempted = run.n_bins
    ms = [v * 1e3 for v in run.lat]
    run.note(bins=run.n_bins, gru_steps=len(run.gru),
             **{f"bin_ms_{name}": tail(ms, q) for name, q in TAILS.items()},
             bins_over_10ms=sum(v > 10.0 for v in ms), **_lateness(run))
    return {"bin_ms_p99": tail(ms, 0.99)}


def traced(run, seconds: float):
    """Bins in three stretches on one schedule: plain, with CUDA events at
    the stack's forward boundary, then the last ``profile_bins`` under
    the profiler, each bin's work a host range 'bin'."""
    tr = run.traffic
    n_prof = min(int(tr["profile_bins"]), run.n_bins // 2)
    a = (run.n_bins - n_prof) // 2
    b = run.n_bins - n_prof
    t0 = now() + 0.01
    _bins(run, t0, 0, a)
    spans = ModuleSpans(run.model, run.cfg["rnn_modules"], backward=False)
    _bins(run, t0, a, b)
    spans = spans.close()
    with profiled(run.device) as prof:
        _bins(run, t0, b, run.n_bins, label="bin")
    run.attempted = run.n_bins
    run.note(**_lateness(run))
    bins = ranges(prof["host"], "bin")
    lo, hi = min(s for s, _ in bins), max(e for _, e in bins)
    dev_ev = prof["device"]
    return {
        "kind": "stream", "spans": spans,
        "span_work": run.fam.span_work(run.cfg, run.traffic, 1, stream=True),
        "device": dev_ev, "bins": bins,
        "busy_s": covered([(s, e) for _, s, e in dev_ev], lo, hi),
        "window_s": hi - lo,
        "breakdown": {
            "device_ops": top_ops(dev_ev, lo, hi),
            "idle_gaps": idle_gaps(dev_ev, prof["host"], lo, hi,
                                   skip=("bin", "sync")),
        },
    }


def release(run) -> None:
    run.failed = sum(1 for lg in run.gru.values()
                     if not bool(torch.isfinite(lg).all()))
    run.prog_power = run.powers[:len(run.syms)].double().cpu()
    for name in ("model", "rt_step", "state", "powers"):
        setattr(run, name, None)
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


def _numbers(run, power, runs, logits, emits) -> dict:
    ref = run.ref_out
    n = len(emits)
    want_power = torch.as_tensor(ref["power"][:n], dtype=torch.float64)
    if list(runs) != ref["runs"][:len(runs)] or len(runs) != sum(
            1 for k in ref["runs"] if k < n):
        logits_gap = float("inf")
    else:
        logits_gap = compare.max_rel(logits, ref["logits"][:len(runs)])
    decided_step = compare.decided(ref["logits"],
                                   run.limits["logits_gap"]).cpu().tolist()
    decided = np.ones(n, dtype=bool)
    for j, k in enumerate(ref["runs"]):
        if k < n:
            decided[k] = decided_step[j] and (j == 0 or decided_step[j - 1])
    differ = np.asarray(emits) != ref["emits"][:n]
    return {
        "power_gap": compare.max_rel(power, want_power),
        "logits_gap": logits_gap,
        "emit_mismatch": int((differ & decided).sum()),
    }


def _reference(run, lower: bool) -> dict:
    return run.ref.stream(run.cfg, run.weights, run.signal[:len(run.syms)],
                          run.b_np, run.a_np, lower=lower)


def numbers(run) -> dict:
    run.ref_out = _reference(run, lower=False)
    runs = sorted(run.gru)
    logits = torch.stack([run.gru[k] for k in runs]) if runs else \
        torch.zeros((0, run.cfg["n_classes"]))
    return _numbers(run, run.prog_power, runs, logits, run.syms)


def control_numbers(run) -> dict:
    ctl = _reference(run, lower=True)
    return _numbers(run, torch.as_tensor(ctl["power"]), ctl["runs"],
                    ctl["logits"], ctl["emits"].tolist())
