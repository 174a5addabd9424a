"""K4's share of its roofline: the bound the reference's inputs give
(``roofline/k4.py``) over K4's device time in the trace (a step's launches:
the state pass and the main pass of each view's backward), over the
window's steps whose bound the reference counted."""

from m2s_bench.harness import HERE, load_file
from m2s_bench.trace import roofline_share

VIEWS = 2


def read(run):
    counts = load_file(HERE / "roofline" / "k4.py")
    return roofline_share(run, counts.KERNEL, counts.PATTERN,
                          launches=VIEWS * counts.LAUNCHES)
