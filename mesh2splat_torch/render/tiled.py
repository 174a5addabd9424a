"""Tile-binned rasterizer (counterpart of ``mesh2splat_tpu.render.tiled``):
projection output -> binning -> compositing, returning the G-buffer dict.
Differentiable with respect to the projected splats."""

from __future__ import annotations

import torch

from ..ops.projection import ProjectedSplats
from ..types import RenderMode
from . import binning as B
from . import composite as C


def rasterize_tiled(proj: ProjectedSplats, width: int, height: int,
                    pair_capacity: int = 0,
                    render_mode: RenderMode = RenderMode.ALBEDO,
                    albedo_only: bool = False):
    """Returns albedo/position/normal/depth/metal_rough (H, W, 4) +
    transmittance (H, W) + dropped_pairs. pair_capacity: class-C pair
    budget (binning.calibrate_overflow); 0 uses a generous heuristic."""
    if int(render_mode) == int(RenderMode.OVERDRAW):
        raise NotImplementedError(
            "RenderMode.OVERDRAW needs the overdraw count kernel (K6), which "
            "the port brings in its overdraw slice"
        )
    ty, tx = B.tiles_for(width, height)
    binned = B.bin_pairs(proj, width, height, pair_capacity,
                         variant="albedo" if albedo_only else "full")
    out = C.composite_tiles(binned.fields, binned.tile_starts, height, ty, tx,
                            albedo_only)
    out = out[:, :height, :width]

    def chans(*idx):
        return torch.stack([out[i] for i in idx], dim=-1)

    return {
        "albedo": chans(0, 1, 2, 3),
        "position": chans(4, 5, 6, 7),
        "normal": chans(8, 9, 10, 3),
        "depth": chans(11, 11, 11, 3),
        "metal_rough": torch.stack(
            [out[12], out[13], torch.zeros_like(out[12]), out[7]], dim=-1),
        "transmittance": 1.0 - out[3],
        "dropped_pairs": binned.dropped_pairs,
        "num_pairs": binned.num_pairs,
    }
