"""Frames completed over the whole window, each synchronised as presented."""


def read(run):
    return run.completed / run.window_s
