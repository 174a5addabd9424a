"""K2 (``fragment_apply``, the per-slot fragment shader that reads the tap
atlas by K1's rows), counted on the reference's call of its plain version.

Bytes: each input read once and each output written once: the 58 used
f32 record fields of every triangle that owns a slot, the atlas groups the
slots read (``counting.tap_bytes``), K1's rows (int32), 4 meta rows and 20
output rows a slot. Operations: 400 f32 a slot."""

from __future__ import annotations

import torch

from m2s_bench.counting import tap_bytes

KERNEL = "k2"
PATTERN = "fragment_kernel"            # its launches in the device trace
TARGET = ("ops.fragment", "fragment_apply_plain")


def counted(fn, records, tapsT, metaT, **kw):
    out = fn(records, tapsT, metaT, **kw)
    cap = metaT.shape[1]
    live = metaT[3] > 0
    n_tri = int(torch.unique(metaT[0][live]).numel())
    taps = (tap_bytes(records, tapsT, metaT, kw["rows"], kw)
            if kw.get("rows") is not None else 0)
    nbytes = 58 * n_tri * 4 + taps + cap * 4 + 4 * cap * 4 + 20 * cap * 4
    return out, (nbytes, cap * 400)
