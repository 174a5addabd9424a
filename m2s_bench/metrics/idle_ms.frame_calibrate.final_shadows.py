"""Device idle ms a frame while the host's innermost span was
``m2s.render.calibrate``: the frame's pair budget
(``render/pipeline.py::calibrate_frame``), its projection excepted."""

from m2s_bench.spans import idle_ms


def read(run):
    return idle_ms(run, "m2s.render.calibrate")
