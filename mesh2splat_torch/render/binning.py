"""Tile binning (counterpart of ``mesh2splat_tpu.render.binning``): per
(32 x 32)-pixel tile, depth-ordered lists of (tile, splat) pair fields.

  * class A: the first tile of every valid splat's span rectangle, one row
    per splat;
  * class C: tiles 2..span of multi-tile splats, through the budgeted
    expansion (cumsum slot allocation, each slot's owner by a binary
    search over the segment ends, gathers);
  * one stable ``torch.sort`` on a single int64 key (tile, depth) orders
    all rows exactly as the JAX package's three-key ``lax.sort`` on
    (tile, f32 depth, row id): the depth bits are mapped to an unsigned
    order with -0.0 == +0.0 and every NaN last, and stability replaces the
    row-id key;
  * per-tile ranges from one searchsorted.

Differentiable with respect to the pair fields (the JAX package's
sort-carry VJP): keys, ``tile_starts`` and the class-C owner search carry no
gradient; the class-C gather sums its cotangent back onto each splat
(``index_select``, whose backward is ``index_add_``), and the sorted gather
un-permutes its cotangent with one indexed store (every row id is unique).
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import segments
from ..ops.projection import ProjectedSplats
from ..utils.profiling import annotate

TILE_H = 32
TILE_W = 32
CHUNK = 128  # the composite walks each tile's pairs in chunks of this size

FIELDS_ALBEDO = (
    "mean_x", "mean_y", "conic_a", "conic_b", "conic_c",
    "col_r", "col_g", "col_b", "alpha",
)
FIELDS_FULL = FIELDS_ALBEDO + (
    "nrm_x", "nrm_y", "nrm_z", "ws_x", "ws_y", "ws_z",
    "depth", "metal", "rough",
)
FIELDS_DEPTH = ("mean_x", "mean_y", "conic_a", "conic_b", "conic_c", "depth")
FIELDS_OVERDRAW = ("mean_x", "mean_y", "conic_a", "conic_b", "conic_c")

VARIANT_FIELDS = {"albedo": FIELDS_ALBEDO, "full": FIELDS_FULL,
                  "depth": FIELDS_DEPTH, "overdraw": FIELDS_OVERDRAW}


def field_index(variant: str) -> dict:
    return {name: i for i, name in enumerate(VARIANT_FIELDS[variant])}


def padded_rows(variant: str) -> int:
    """Row count of the (F_pad, P) buffer: fields rounded up to 8."""
    f = len(VARIANT_FIELDS[variant])
    return -(-f // 8) * 8


@dataclasses.dataclass
class BinnedPairs:
    """Tile t owns rows [tile_starts[t], tile_starts[t+1]) of ``fields``."""

    fields: torch.Tensor         # (F_pad, P_cap) f32, sorted by (tile, depth)
    tile_starts: torch.Tensor    # (num_tiles + 1,) int32
    num_pairs: torch.Tensor      # scalar int32 (live pairs)
    dropped_pairs: torch.Tensor  # scalar: class-C pairs lost to the budget

    @property
    def capacity(self):
        return self.fields.shape[1]

    @property
    def tile_counts(self):
        return self.tile_starts[1:] - self.tile_starts[:-1]


def tiles_for(width: int, height: int) -> tuple[int, int]:
    return -(-height // TILE_H), -(-width // TILE_W)


def depth_sort_bits(depth: torch.Tensor) -> torch.Tensor:
    """f32 -> int64 in [0, 2^32) ordered as ``lax.sort`` orders floats:
    -inf < ... < -0.0 == +0.0 < ... < inf < NaN (all NaNs equal)."""
    d = torch.where(depth == 0.0, 0.0, depth)
    d = torch.where(torch.isnan(d), float("nan"), d)
    bits = d.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    neg = bits >= 0x80000000
    return torch.where(neg, 0xFFFFFFFF - bits, bits | 0x80000000)


class _SortCarry(torch.autograd.Function):
    """vals[:, perm] for a permutation ``perm`` of the columns. Backward:
    the cotangent goes back to its unsorted columns by one indexed store,
    as the JAX package re-sorts it by the carried row id."""

    @staticmethod
    def forward(ctx, vals, perm):
        ctx.save_for_backward(perm)
        return vals[:, perm]

    @staticmethod
    def backward(ctx, g):
        (perm,) = ctx.saved_tensors
        out = torch.empty_like(g)
        out[:, perm] = g
        return out, None


def _tile_geom(proj: ProjectedSplats, width: int, height: int, band_ty=None):
    """Per-splat tile bbox (tx0, ty0, sx, sy) + validity.

    band_ty: optional per-splat (ty_lo, ty_hi) int32 tile-row clamp, the
    per-face scissor of the fused shadow cubemap (six faces stacked as row
    bands of one tall image; no splat's pairs may bleed into a neighbouring
    face's band)."""
    ty, tx = tiles_for(width, height)
    mean_x = (proj.mean_ndc[:, 0] + 1.0) * (width * 0.5)
    mean_y = (proj.mean_ndc[:, 1] + 1.0) * (height * 0.5)
    ext = proj.axes_px[:, 0].abs() + proj.axes_px[:, 1].abs() + 1e-3

    x_lo = mean_x - ext[:, 0]
    x_hi = mean_x + ext[:, 0]
    row_c = float(height) - mean_y  # row 0 = top
    y_lo = row_c - ext[:, 1]
    y_hi = row_c + ext[:, 1]

    def tile_of(v, size, lo, hi):
        return torch.clamp(torch.floor(v / size).to(torch.int32), lo, hi)

    ty_lo, ty_hi = (0, ty - 1) if band_ty is None else band_ty
    tx0 = tile_of(x_lo, TILE_W, 0, tx - 1)
    tx1 = tile_of(x_hi, TILE_W, 0, tx - 1)
    ty0 = tile_of(y_lo, TILE_H, ty_lo, ty_hi)
    ty1 = tile_of(y_hi, TILE_H, ty_lo, ty_hi)
    on_screen = (x_hi >= 0) & (x_lo < width) & (y_hi >= 0) & (y_lo < height)
    valid = proj.valid & on_screen
    if band_ty is not None:
        # a quad wholly outside its band claims no tile (the clamps above
        # can leave ty0 > ty1 there)
        valid = valid & (y_hi >= (ty_lo * TILE_H).to(torch.float32)) \
            & (y_lo < ((ty_hi + 1) * TILE_H).to(torch.float32))
    return (mean_x, mean_y), tx0, ty0, tx1 - tx0 + 1, ty1 - ty0 + 1, valid


def _record_columns(proj: ProjectedSplats, mean_xy, variant: str):
    cols = {
        "mean_x": mean_xy[0], "mean_y": mean_xy[1],
        "conic_a": proj.conic[:, 0], "conic_b": proj.conic[:, 1],
        "conic_c": proj.conic[:, 2],
        "col_r": proj.color[:, 0], "col_g": proj.color[:, 1],
        "col_b": proj.color[:, 2], "alpha": proj.color[:, 3],
        "nrm_x": proj.normal[:, 0], "nrm_y": proj.normal[:, 1],
        "nrm_z": proj.normal[:, 2],
        "ws_x": proj.wspos[:, 0], "ws_y": proj.wspos[:, 1],
        "ws_z": proj.wspos[:, 2],
        "depth": proj.depth, "metal": proj.pbr[:, 0], "rough": proj.pbr[:, 1],
    }
    return torch.stack([cols[name] for name in VARIANT_FIELDS[variant]])


def default_c_capacity(n_splats: int) -> int:
    """Uncalibrated class-C budget (overflow drops beyond-first-tile pairs
    of multi-tile splats); callers with telemetry use calibrate_overflow."""
    return max(4 * n_splats, 1 << 13)


def bin_pairs(proj: ProjectedSplats, width: int, height: int,
              c_capacity: int = 0, variant: str = "full",
              band_ty=None) -> BinnedPairs:
    """Depth-ordered per-tile pair field lists from projected splats.
    band_ty: optional per-splat tile-row clamp (see _tile_geom), used by
    the fused shadow cubemap."""
    with annotate("m2s.render.bin"):
        n = proj.capacity
        dev = proj.depth.device
        ty, tx = tiles_for(width, height)
        num_tiles = ty * tx
        # the JAX package packs (tx0, ty0, sx) into 7 + 11 + 7 bits; keep its
        # image-size limit so both accept the same inputs
        if tx > 127 or ty > 2047:
            raise ValueError(
                f"image {width}x{height} exceeds the binner's packed-geometry "
                f"budget ({127 * TILE_W}x{2047 * TILE_H} max)"
            )
        if not c_capacity:
            c_capacity = default_c_capacity(n)

        mean_xy, tx0, ty0, sx, sy, valid = _tile_geom(proj, width, height,
                                                      band_ty)
        pairs_n = sx * sy
        vals = _record_columns(proj, mean_xy, variant)  # (F, N)
        nf = vals.shape[0]

        with torch.no_grad():
            # class A: first tile of every valid splat
            tile_a = torch.where(valid, ty0 * tx + tx0, num_tiles)

            # class C: tiles 2..span through the budgeted expansion
            counts_c = torch.where(valid & (pairs_n > 1), pairs_n - 1, 0)
            off_c, tot_c = segments.alloc_slots(counts_c, c_capacity)
            owner = segments.owner_of_slots(off_c, counts_c, c_capacity)
            slot = torch.arange(c_capacity, dtype=torch.int32, device=dev)
            live_c = slot < tot_c
            # +1: the span's first (row-major) tile rides in class A
            local_c = slot - off_c[owner] + 1
            sx_c = torch.clamp(sx[owner], min=1)
            dy_c = torch.div(local_c, sx_c, rounding_mode="floor")
            dx_c = local_c - dy_c * sx_c
            tile_c = (ty0[owner] + dy_c) * tx + tx0[owner] + dx_c
            tile_c = torch.where(live_c, tile_c, num_tiles)

            tile_rows = torch.cat([tile_a, tile_c])
            depth = proj.depth.detach()
            depth_rows = torch.cat([depth, depth[owner]])
            key = ((tile_rows.to(torch.int64) << 32)
                   | depth_sort_bits(depth_rows))
            sorted_key, perm = torch.sort(key, stable=True)
            tile_starts = segments.segment_starts(sorted_key >> 32, num_tiles)
            dropped = torch.clamp(counts_c.sum() - c_capacity, min=0)

        # index_select, not vals[:, owner]: its backward is one index_add_ onto
        # the owners, where indexing's is a sorted index_put over a strided dim
        # (two thirds of a 1080p training step on an H100, profile_port.py)
        val_rows = torch.cat([vals, vals.index_select(1, owner)], dim=1)
        rows = val_rows.shape[1]
        f_pad = padded_rows(variant)
        rows_pad = -(-rows // CHUNK) * CHUNK
        fields = torch.nn.functional.pad(_SortCarry.apply(val_rows, perm),
                                         (0, rows_pad - rows, 0, f_pad - nf))
        return BinnedPairs(fields=fields, tile_starts=tile_starts,
                           num_pairs=tile_starts[num_tiles],
                           dropped_pairs=dropped)


@torch.no_grad()
def required_overflow(proj: ProjectedSplats, width: int, height: int,
                      band_ty=None):
    """Exact class-C (beyond-first-tile) pair requirement."""
    _, _, _, sx, sy, valid = _tile_geom(proj, width, height, band_ty)
    pairs_n = sx * sy
    return torch.where(valid & (pairs_n > 1), pairs_n - 1, 0).sum()


def round_pow2_budget(need, floor: int = 8192) -> int:
    """Round a pair/slot requirement up to a power of two, with a floor."""
    return 1 << max(int(need) - 1, floor).bit_length()


def calibrate_overflow(proj: ProjectedSplats, width: int, height: int,
                       round_to: int = 8192) -> int:
    """Class-C budget for this projection, rounded up to ``round_to``."""
    need = int(required_overflow(proj, width, height))
    return max(-(-need // round_to) * round_to, round_to)
