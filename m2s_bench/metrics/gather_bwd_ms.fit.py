"""Binning's VJP: device ms a step of the work launched inside the autograd
nodes of ``render/binning.py::bin_pairs`` (the sorted gather's un-permuting
indexed store, ``_SortCarryBackward``, and the class-C gather's
``index_add_``, ``IndexSelectBackward0``), by the host op each launch links
to in the trace."""

NODES = (r"^autograd::engine::evaluate_function: "
         r"(_SortCarryBackward|IndexSelectBackward0)$")


def read(run):
    if run.trace is None or not run.completed:
        return None
    s = run.trace.device_s_under(NODES)
    return s * 1e3 / run.completed if s > 0.0 else None
