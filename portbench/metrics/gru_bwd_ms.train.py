"""gru_bwd_ms.train: device ms a profiled train step spends inside the
port's backward GRU kernel spans (``gru_bwd``, ``gru_wbwd``: a call's gate
recompute, its sweep of step launches, dx and the weight gradients,
between their CUDA events), summed over the profiled steps and divided by
the steps they fall in. None where the port keeps no such span."""

from portbench.core.spec import reader

BACKWARD = ("gru_bwd", "gru_wbwd")


def read(rec):
    if rec.get("kind") != "train":
        return None
    picked = [r for r in reader("gru_roofline.train").in_window(
        rec, BACKWARD) if r["device_ms"] is not None]
    steps = {r["step"] for r in picked}
    if not steps:
        return None
    return sum(r["device_ms"] for r in picked) / len(steps)
