"""decode_idle.eval: the device-idle time inside the port's ``decode``
and ``per`` spans (greedy decoding and the phoneme error rate of each
eval step), as a share (%) of the profiled stretch's wall time (the
reduction of ``step_idle.train``)."""

from portbench.core.spec import reader


def read(rec):
    return reader("step_idle.train").idle_inside(rec, "eval",
                                                 ("decode", "per"))
