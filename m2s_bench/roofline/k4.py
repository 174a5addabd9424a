"""K4 (``composite_tiles``' backward: the state pass and the main pass over
each tile's segments), counted on the reference's call of its plain
version, as one kernel: the two passes of one backward share its bound.

Bytes: the fields of every binned pair (18 rows full, 9 albedo), the tile
starts, the cotangent's channels it reads (14 full, 4 albedo) and the
per-pixel totals (2, 1), and the (F_pad, P) gradient written once.
Operations, over every chunk of every tile (K4 has no early exit): ~100
f32 a pair (the plane coefficients and the chain to the mean and conic
rows), and a covered (pair, pixel) the coverage test (22) and the
backward's own terms (98 full, 48 albedo)."""

from __future__ import annotations

from m2s_bench.counting import covered_pairs

KERNEL = "k4"
PATTERN = "segment_state_kernel|composite_bwd_kernel"
TARGET = ("render.composite", "composite_backward_plain")
LAUNCHES = 2    # a backward's launches: the state pass, the main pass


def counted(fn, fields, tile_starts, out, ct, height, ty, tx, albedo_only,
            **kw):
    dfields = fn(fields, tile_starts, out, ct, height, ty, tx, albedo_only,
                 **kw)
    variant = "albedo" if albedo_only else "full"
    cov, _ = covered_pairs(fields, tile_starts, height, ty, tx, variant,
                           tile_batch=kw.get("tile_batch", 256))
    pairs = int(tile_starts[-1])
    n_fields, n_ct, n_res, per_px = ((9, 4, 1, 48) if albedo_only
                                     else (18, 14, 2, 98))
    px_bytes = ty * 32 * tx * 32 * 4
    nbytes = (n_fields * pairs * 4 + (ty * tx + 1) * 4
              + (n_ct + n_res) * px_bytes + fields.numel() * 4)
    return dfields, (nbytes, pairs * 100 + cov * (22 + per_px))
