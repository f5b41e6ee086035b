"""device_idle.train: 1 - the union of device operations over the wall time
of the profiled steps, %."""

from portbench.core.reduce import idle


def read(rec):
    return idle(rec, "train")
