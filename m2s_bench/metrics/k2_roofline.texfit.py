"""K2's share of its roofline in a texture-fitting step (one launch a
step, in the step's conversion): the bound the reference's inputs give
(``roofline/k2.py``) over K2's device time in the trace, over the window's
steps whose bound the reference counted."""

from m2s_bench.harness import HERE, load_file
from m2s_bench.trace import roofline_share


def read(run):
    counts = load_file(HERE / "roofline" / "k2.py")
    return roofline_share(run, counts.KERNEL, counts.PATTERN)
