"""Texture-fitting steps completed over the whole traced window, each
synchronised: the fitter's host-paced rate, under the profiler (which
slows the host's op issue)."""


def read(run):
    return run.completed / run.window_s
