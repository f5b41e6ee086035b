"""mfu.train: model FLOP rate of the train step as a share (%) of the chip's
TF32 peak, over the traced run's steps outside the profiler's stretch."""

from portbench.core.reduce import mfu


def read(rec):
    return mfu(rec, "train")
