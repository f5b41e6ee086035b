"""gru_fwd_ms.train: device ms a profiled train step spends inside the
port's forward GRU kernel spans (``gru_fwd``, ``gru_wfwd``, ``gru_bifwd``:
a call's input projection and its sweep of step kernels, between their
CUDA events), summed over the profiled steps and divided by the steps they
fall in. None where the port keeps no such span."""

from portbench.core.spec import reader

FORWARD = ("gru_fwd", "gru_wfwd", "gru_bifwd")


def read(rec):
    if rec.get("kind") != "train":
        return None
    picked = [r for r in reader("gru_roofline.train").in_window(
        rec, FORWARD) if r["device_ms"] is not None]
    steps = {r["step"] for r in picked}
    if not steps:
        return None
    return sum(r["device_ms"] for r in picked) / len(steps)
