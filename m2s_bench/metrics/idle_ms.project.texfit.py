"""Device idle ms a texture-fitting step while the host's innermost span
was ``m2s.render.project``: projection (``ops/projection.py::
project_splats``, one call a view)."""

from m2s_bench.spans import idle_ms


def read(run):
    return idle_ms(run, "m2s.render.project")
