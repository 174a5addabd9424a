"""Device idle ms a frame while the host's innermost span was
``m2s.render.project``: projection (``ops/projection.py::project_splats``,
both of a frame's calls)."""

from m2s_bench.spans import idle_ms


def read(run):
    return idle_ms(run, "m2s.render.project")
