"""Device idle ms a frame while the host's innermost span was
``m2s.render.shadow``: the shadow cubemap
(``render/shadows.py::render_shadow_cubemap``: prep, K5), its binning
excepted."""

from m2s_bench.spans import idle_ms


def read(run):
    return idle_ms(run, "m2s.render.shadow")
