"""Reductions the per-layer readers share, from a traced run's record
(``loops.train.record`` and ``loops.stream.traced``)."""

from __future__ import annotations

from portbench.core.peaks import PEAK_FLOPS, least_seconds
from portbench.core.stats import Union


def mfu(rec: dict, kind: str):
    """Model FLOPs of the plain stretch's steps over its time, as a share
    (%) of the peak."""
    if rec.get("kind") != kind or not rec.get("plain_steps"):
        return None
    rate = rec["flops_per_step"] * rec["plain_steps"] / rec["plain_s"]
    return 100.0 * rate / PEAK_FLOPS


def roofline(rec: dict, kind: str):
    """The stacks' least time (each call's FLOPs and bytes, from shapes)
    over their device time between the boundary events, in %."""
    if rec.get("kind") != kind or not rec.get("spans"):
        return None
    least = sum(least_seconds(*rec["span_work"][(mod, phase)])
                for mod, phase, _ in rec["spans"])
    spent = sum(ms for _, _, ms in rec["spans"]) / 1e3
    return 100.0 * least / spent if spent > 0 else None


def idle(rec: dict, kind: str):
    """1 - the union of device operations over the profiled stretch, %."""
    if rec.get("kind") != kind or rec.get("window_s", 0) <= 0 \
            or not rec["device"]:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])


def idle_in_bins(rec: dict):
    """The share (%) of the profiled bins' processing intervals (from
    taking the bin to its result on the host) with no device operation."""
    if rec.get("kind") != "stream" or not rec.get("bins") or \
            not rec["device"]:
        return None
    union = Union([(s, e) for _, s, e in rec["device"]])
    total = sum(e - s for s, e in rec["bins"])
    busy = sum(union.covered(s, e) for s, e in rec["bins"])
    return 100.0 * (1.0 - busy / total)


def span_ms(rec: dict, kind: str, module: str, phase: str = "fwd"):
    """Mean device ms of one call of ``module`` over the spans."""
    ms = [v for m, p, v in rec.get("spans", ()) if m == module and
          p == phase]
    if rec.get("kind") != kind or not ms:
        return None
    return sum(ms) / len(ms)
