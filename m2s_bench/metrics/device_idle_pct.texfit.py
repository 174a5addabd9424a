"""The device's idle share of the window: 100 x (1 - the union of its
kernel, copy and fill intervals in the trace / the window)."""

from m2s_bench.trace import idle_pct


def read(run):
    return idle_pct(run)
