"""Device idle ms a texture-fitting step while the host's innermost span
was ``m2s.convert.slots``: the step's slot allocation
(``ops/conversion.py::_expand_slots``: attributes, rows, slot fills)."""

from m2s_bench.spans import idle_ms


def read(run):
    return idle_ms(run, "m2s.convert.slots")
