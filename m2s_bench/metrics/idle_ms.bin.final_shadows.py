"""Device idle ms a frame while the host's innermost span was
``m2s.render.bin``: binning (``render/binning.py::bin_pairs``, the cubemap's
and the frame's)."""

from m2s_bench.spans import idle_ms


def read(run):
    return idle_ms(run, "m2s.render.bin")
