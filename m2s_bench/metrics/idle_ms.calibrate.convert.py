"""Device idle ms a conversion while the host's innermost span was
``m2s.convert.calibrate``: the conversion's calibration of its row and slot
budgets (``ops/conversion.py::calibrate``)."""

from m2s_bench.spans import idle_ms


def read(run):
    return idle_ms(run, "m2s.convert.calibrate")
