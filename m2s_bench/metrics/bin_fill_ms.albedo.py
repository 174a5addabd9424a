"""Binning's fills: device ms a frame of torch's cummax scan kernel
(``render/binning``' owner fills, the frame's and the shadow cubemap's; no
conversion runs in the window)."""

from m2s_bench.trace import device_ms_per_unit

CUMMAX = "scan_innermost_dim_with_indices"


def read(run):
    return device_ms_per_unit(run, CUMMAX)
