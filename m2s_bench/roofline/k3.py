"""K3 (``composite_tiles``' forward: the per-tile front-to-back composite
of the G-buffer), counted on the reference's call of its plain version.

Bytes: the fields of every binned pair (18 rows full, 9 albedo), the tile
starts, and the (16, H, W) G-buffer written once. Operations, over the
chunks each tile walks before its early exit: ~60 f32 a pair (the conic's
axes and the plane coefficients), and a covered (pair, pixel) the coverage
test (22) and the composite's own terms (39 full, 15 albedo)."""

from __future__ import annotations

from m2s_bench.counting import covered_pairs, walked_chunks

KERNEL = "k3"
PATTERN = "composite_kernel"
TARGET = ("render.composite", "composite_plain")


def counted(fn, fields, tile_starts, height, ty, tx, albedo_only, **kw):
    img, walked = fn(fields, tile_starts, height, ty, tx, albedo_only,
                     **dict(kw, return_walked=True))
    variant = "albedo" if albedo_only else "full"
    cov, n_walked = covered_pairs(fields, tile_starts, height, ty, tx,
                                  variant, walked_chunks(tile_starts, walked))
    n_fields = 9 if albedo_only else 18
    pairs = int(tile_starts[-1])
    nbytes = (n_fields * pairs * 4 + (ty * tx + 1) * 4
              + 16 * ty * 32 * tx * 32 * 4)
    flops = n_walked * 60 + cov * (22 + (15 if albedo_only else 39))
    return (img if not kw.get("return_walked") else (img, walked),
            (nbytes, flops))
