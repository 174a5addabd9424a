"""The host's blocking waits a conversion (runtime synchronisations and
synchronous copies) inside ``Scene.convert``'s span."""

from m2s_bench.spans import syncs


def read(run):
    return syncs(run)
