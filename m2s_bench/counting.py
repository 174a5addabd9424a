"""Work counts of the kernels, worked out on the reference's own inputs:
frozen copies of the port's smoke-test arithmetic (``tap_bytes``,
``covered_pairs``). They take the reference's modules, never the program's,
so a later change of a kernel or of its wrapper cannot move them.
"""

from __future__ import annotations

import torch

from .reference.ops import fragment as RF
from .reference.render import binning as RB
from .reference.render import composite as RC


def tap_bytes(rec, atlas, meta, rows, kw) -> int:
    """The atlas bytes K2 must read on these inputs: once each distinct
    (column, sub-texel group) a slot reads, 40 f32 (160 B); packed, once
    each distinct run of int32 words that holds a group (k = 1: 20 words
    hold both halves of its one group; k >= 2: 40 words hold two groups).
    ``meta`` must already hold each slot's local (row 2)."""
    k = kw["k"]
    g = RF._gather_rec(rec, meta)
    su = RF._slot_uv(g, meta, kw["res"])
    sub = RF._tap_index(su["uu"], su["vv"], g[RF.REC["mid"]],
                        g[RF.REC["lod"]], kw["geom"], k)[1]
    del g, su
    j = torch.where((sub > 0) & (sub < k), sub, 0).long()
    if not kw["taps_packed"]:
        return int(torch.unique(rows.long() * k + j).numel()) * 160
    if k == 1:
        return int(torch.unique(rows).numel()) * 80
    blocks = k // 2          # runs of 40 words a column
    return int(torch.unique(rows.long() * blocks + j % blocks).numel()) * 160


@torch.no_grad()
def covered_pairs(fields, starts, height, ty, tx, variant, chunks=None,
                  tile_batch=256):
    """The (pair, pixel) combinations the plain coverage test (g > 0) finds
    covered: over every chunk of every tile, or over chunks [lo, hi) of
    each tile where ``chunks`` gives the per-tile (lo, hi). Returns
    (covered, pairs in those chunks)."""
    idx = RB.field_index(variant)
    first, ends, aligned, num_chunks = RC._tile_ranges(starts)
    c_lo, c_hi = chunks if chunks is not None else (
        torch.zeros_like(num_chunks), num_chunks)
    pix = RC._pixel_coords(fields.device)
    lane = torch.arange(RC.CHUNK, device=fields.device)
    n_tiles = ty * tx
    total = torch.zeros((), dtype=torch.int64, device=fields.device)
    pairs = torch.zeros((), dtype=torch.int64, device=fields.device)
    for b0 in range(0, n_tiles, tile_batch):
        tiles = torch.arange(b0, min(b0 + tile_batch, n_tiles),
                             device=fields.device)
        tjf, py0 = RC._tile_origin(tiles, tx, height)
        s, e, al = first[tiles], ends[tiles], aligned[tiles]
        lo, hi = c_lo[tiles], c_hi[tiles]
        for c in range(int(hi.max()) if tiles.numel() else 0):
            rows = al[:, None] + c * RC.CHUNK + lane
            live = ((rows >= s[:, None]) & (rows < e[:, None])
                    & ((c >= lo) & (c < hi))[:, None])
            st = fields[:, rows.clamp(max=fields.shape[1] - 1)]
            g, _, _ = RC._chunk_planes(
                lambda name: st[idx[name]][..., None], tjf, py0, pix,
                live[..., None])
            total += (g > 0).sum()
            pairs += live.sum()
    return int(total), int(pairs)


def walked_chunks(starts, walked):
    """Per tile the chunk range [0, hi) K3 walks before its early exit,
    from the pairs each tile walked."""
    first, _, aligned, _ = RC._tile_ranges(starts)
    w = walked.long()
    hi = torch.where(w > 0, torch.div(first + w - aligned + RC.CHUNK - 1,
                                      RC.CHUNK, rounding_mode="floor"), 0)
    return torch.zeros_like(hi), hi
