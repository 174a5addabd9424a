"""Device idle ms a conversion while the host's innermost span was
``m2s.convert.bbox``: ``Scene.convert``'s bounds of the asset (numpy) and
their copies to the device."""

from m2s_bench.spans import idle_ms


def read(run):
    return idle_ms(run, "m2s.convert.bbox")
