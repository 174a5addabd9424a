"""Device idle ms a step while the host's innermost span was
``m2s.convert.fragment_vjp``: the fragment VJP
(``ops/fragment.py::_FragmentApply.backward``)."""

from m2s_bench.spans import idle_ms


def read(run):
    return idle_ms(run, "m2s.convert.fragment_vjp")
