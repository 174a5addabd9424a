"""The fragment VJP: device ms a step of the work launched inside the
autograd node of ``ops/fragment.py::_FragmentApply`` (its backward, which
gathers each slot's taps again from the atlas, recomputes the fragment
math under autograd and carries the gradient to the atlas through
``index_select``'s backward), by the host op each launch links to in the
trace."""

NODES = r"^autograd::engine::evaluate_function: _FragmentApplyBackward$"


def read(run):
    if run.trace is None or not run.completed:
        return None
    s = run.trace.device_s_under(NODES)
    return s * 1e3 / run.completed if s > 0.0 else None
