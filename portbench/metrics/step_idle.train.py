"""step_idle.train: the device-idle time inside the port's ``train_step``
spans, as a share (%) of the profiled stretch's wall time: the part of
``device_idle.train`` that the port's step owns (the rest lies in the
caller's gather between steps). None where the port keeps no such span."""

from portbench.core.spec import reader
from portbench.core.stats import Union, merge


def idle_inside(rec: dict, kind: str, names):
    """Seconds of the spans named ``names`` (their union) in which no
    device operation runs, as a share (%) of ``window_s``."""
    if rec.get("kind") != kind or rec.get("window_s", 0) <= 0:
        return None
    picked = reader("gru_roofline.train").in_window(rec, names)
    if not picked:
        return None
    busy = Union([(s, e) for _, s, e in rec["device"]])
    idle = sum((e - s) - busy.covered(s, e)
               for s, e in merge([(r["start_s"], r["end_s"])
                                  for r in picked]))
    return 100.0 * idle / rec["window_s"]


def read(rec):
    return idle_inside(rec, "train", ("train_step",))
