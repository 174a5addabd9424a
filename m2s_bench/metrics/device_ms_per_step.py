"""The card's busy time a training step: the union of the device's
intervals (kernels, copies, fills) in the window's CUPTI trace, over the
steps the window completed. Nothing when the window was not traced."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0.0 or not run.completed:
        return None
    return run.trace.busy_s * 1e3 / run.completed
