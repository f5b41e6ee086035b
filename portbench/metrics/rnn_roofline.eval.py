"""rnn_roofline.eval: the recurrent stacks' least time over their device
time between CUDA events at the stacks' module boundaries, %."""

from portbench.core.reduce import roofline


def read(rec):
    return roofline(rec, "eval")
