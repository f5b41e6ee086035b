"""day_layer_ms.train: device ms a profiled train step spends inside the
port's ``day_layer`` spans (the day-specific input layer's forward and
backward, between their CUDA events), summed over the profiled steps and
divided by the steps they fall in. None where the port keeps no such
span."""

from portbench.core.spec import reader


def day_layer_ms(rec: dict, kind: str):
    if rec.get("kind") != kind:
        return None
    picked = [r for r in reader("gru_roofline.train").in_window(
        rec, ("day_layer",)) if r["device_ms"] is not None]
    steps = {r["step"] for r in picked}
    if not steps:
        return None
    return sum(r["device_ms"] for r in picked) / len(steps)


def read(rec):
    return day_layer_ms(rec, "train")
