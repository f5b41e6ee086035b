"""device_idle.stream: the share (%) of each profiled bin's processing
interval, from taking the bin to its result on the host, in which no
device operation runs."""

from portbench.core.reduce import idle_in_bins


def read(rec):
    return idle_in_bins(rec)
