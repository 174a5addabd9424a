"""The host's blocking waits a frame (runtime synchronisations and synchronous
copies) inside ``Scene.render``'s span."""

from m2s_bench.spans import syncs


def read(run):
    return syncs(run)
