"""The table of peaks and the roofline rule the benchmark holds kernels to.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at the full
700 W limit): 3.35 TB/s of HBM3 bandwidth and 67 TFLOP/s in float32 outside
the tensor cores. The card's power limit is printed beside every share.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the chip could take: the larger of the bytes at the
    HBM bandwidth and the f32 operations at the f32 peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)
