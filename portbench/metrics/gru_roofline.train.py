"""gru_roofline.train: the GRU kernel calls' least time over their device
time, %, over the profiled train steps.

Reads the port's own spans (``utils/profiling.py:spans``): one a kernel
call, named by its launch counter's key, with the call's shapes and the
device ms between the CUDA events that bracket it. A call's least time is
``least_seconds`` of ``gru_layer_work`` at those shapes (the work formula
of ``rnn_roofline``, the input's bytes as the call read them), times its
directions. None where the port keeps no such span.
"""

from portbench.core.flops import gru_layer_work
from portbench.core.peaks import least_seconds

PHASE = {"gru_fwd": "fwd", "gru_wfwd": "fwd", "gru_bifwd": "fwd",
         "gru_bwd": "bwd", "gru_wbwd": "bwd"}


def port_spans():
    """The port's span records, or None where the port has none to give."""
    try:
        from cross_patient_speech_decoding_tpu_torch.utils.profiling import (
            spans,
        )
    except ImportError:
        return None
    return spans()


def in_window(rec: dict, names) -> list:
    """The port's spans named in ``names`` that overlap the traced run's
    profiled stretch (from its first device operation to its last), as
    dicts with ``start_s`` and ``end_s`` on the record's clock."""
    recs = port_spans()
    if not recs or not rec.get("device"):
        return []
    lo = min(s for _, s, _ in rec["device"])
    hi = max(e for _, _, e in rec["device"])
    out = []
    for r in recs:
        if r["name"] in names:
            s, e = r["start_ns"] * 1e-9, r["end_ns"] * 1e-9
            if e >= lo and s <= hi:
                out.append({**r, "start_s": s, "end_s": e})
    return out


def least_s(phase: str, attrs: dict) -> float:
    """The least seconds of one kernel call from its span's attributes."""
    T, B, F, H = attrs["T"], attrs["B"], attrs["F"], attrs["H"]
    work = gru_layer_work(T, B, F, H, need_dx=attrs["need_dx"])
    flops, nbytes = (work[0], work[1]) if phase == "fwd" else \
        (work[2], work[3])
    nbytes += attrs["x_bytes"] - T * B * F * 4
    return attrs["directions"] * least_seconds(flops, nbytes)


def roofline(rec: dict, kind: str, phases):
    if rec.get("kind") != kind:
        return None
    least = spent = 0.0
    for r in in_window(rec, [k for k, p in PHASE.items() if p in phases]):
        if r["device_ms"] is not None:
            least += least_s(PHASE[r["name"]], r["attrs"])
            spent += r["device_ms"] / 1e3
    return 100.0 * least / spent if spent > 0 else None


def read(rec):
    return roofline(rec, "train", ("fwd", "bwd"))
