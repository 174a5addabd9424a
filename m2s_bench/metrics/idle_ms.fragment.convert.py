"""Device idle ms a conversion while the host's innermost span was
``m2s.convert.fragment``: the fragment stage
(``ops/conversion.py::_finish_convert``: records, atlas, K1, K2)."""

from m2s_bench.spans import idle_ms


def read(run):
    return idle_ms(run, "m2s.convert.fragment")
