"""Device idle ms a step while the host was in the step's backward
(``loss.backward()``: from the first to the last autograd node evaluated,
``spans.training_spans``)."""

from m2s_bench.spans import BACKWARD, idle_ms


def read(run):
    return idle_ms(run, BACKWARD)
