"""input_stage_ms.train: device ms a profiled train step spends in the
port's input stage, the ``augment`` (the trainer's noise), ``smooth`` (the
Gaussian smoothing) and ``day_layer`` spans (the day layers' forward and
backward), between their CUDA events, summed over the profiled steps and
divided by the steps they fall in. None where the port keeps none of these
spans, or none of the first two (a program without the noise and the
smoothing)."""

from portbench.core.spec import reader

INPUT_STAGE = ("augment", "smooth", "day_layer")


def read(rec):
    if rec.get("kind") != "train":
        return None
    picked = [r for r in reader("gru_roofline.train").in_window(
        rec, INPUT_STAGE) if r["device_ms"] is not None]
    if not any(r["name"] != "day_layer" for r in picked):
        return None
    steps = {r["step"] for r in picked}
    return sum(r["device_ms"] for r in picked) / len(steps)
