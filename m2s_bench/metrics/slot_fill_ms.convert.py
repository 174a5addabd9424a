"""Slot allocation's fills: device ms a conversion of torch's cummax scan
kernel (``ops/segments``' fills over the slots and rows)."""

from m2s_bench.trace import device_ms_per_unit

CUMMAX = "scan_innermost_dim_with_indices"


def read(run):
    return device_ms_per_unit(run, CUMMAX)
