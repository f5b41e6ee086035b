"""rnn_step_ms.stream: device ms between the events at the stack's
forward boundary, averaged over the GRU steps of the spans' stretch."""

from portbench.core.reduce import span_ms


def read(rec):
    return span_ms(rec, "stream", "rnn")
