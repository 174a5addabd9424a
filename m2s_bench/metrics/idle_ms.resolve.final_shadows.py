"""Device idle ms a frame while the host's innermost span was
``m2s.render.resolve``: PCF and lighting
(``render/pipeline.py::_frame_core``)."""

from m2s_bench.spans import idle_ms


def read(run):
    return idle_ms(run, "m2s.render.resolve")
