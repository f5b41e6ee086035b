"""gru_roofline.eval: the GRU forward kernel calls' least time over their
device time, %, over the profiled eval steps (the port's spans; the
reduction of ``gru_roofline.train``)."""

from portbench.core.spec import reader


def read(rec):
    return reader("gru_roofline.train").roofline(rec, "eval", ("fwd",))
