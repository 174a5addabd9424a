"""K5 (``min_depth_tiles``, the per-pixel minimum depth of the shadow
cubemap's faces), counted on the reference's call of its plain version.

Bytes: the 6 "depth" field rows of every binned pair, the tile starts and
the depth map written once. Operations: ~60 f32 a pair and, a covered
(pair, pixel), the coverage test (22) and the minimum (3); K5 walks every
chunk (no early exit)."""

from __future__ import annotations

from m2s_bench.counting import covered_pairs

KERNEL = "k5"
PATTERN = "single_channel_kernel"
TARGET = ("render.composite", "min_depth_plain")


def counted(fn, fields, tile_starts, height, ty, tx, **kw):
    out = fn(fields, tile_starts, height, ty, tx, **kw)
    cov, _ = covered_pairs(fields, tile_starts, height, ty, tx, "depth")
    pairs = int(tile_starts[-1])
    nbytes = 6 * pairs * 4 + (ty * tx + 1) * 4 + ty * 32 * tx * 32 * 4
    return out, (nbytes, pairs * 60 + cov * (22 + 3))
