"""The benchmark's assets, made from the seed on the run's device.

A frozen copy of the port's smoke-test asset (a perturbed lat-long sphere
with base-colour, normal and metallic-roughness maps, as bench.py's
``synth_mesh`` makes it), written with torch on the device in a few large
calls instead of a Python loop over quads in numpy. The same seed gives the
same asset on the same device. The program and the reference are both
given these tensors and nothing derived from them.
"""

from __future__ import annotations

import math

import torch

ASSET_STREAMS = 64   # assets of one run draw from seed * ASSET_STREAMS + i


def asset_seed(seed: int, index: int) -> int:
    """The generator seed of the run's asset ``index`` (below 2**63)."""
    return (int(seed) * ASSET_STREAMS + index) % (1 << 63)


def synth_asset(n_tri: int, tex: int, seed: int, device,
                shape_seed: int | None = None) -> dict:
    """One asset as a dict of tensors on ``device``: the triangle soup
    (tri_pos, tri_normal, tri_tangent, tri_uv: (T, 3, C) f32), the factors
    and the three (tex, tex, C) f32 maps. T is 2 * rows * cols of the
    lat-long grid, at most ``n_tri``. The shape's perturbation is drawn
    from ``shape_seed`` where it is given, else from ``seed`` as the maps
    are."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    g_shape = g
    if shape_seed is not None:
        g_shape = torch.Generator(device=dev)
        g_shape.manual_seed(shape_seed)
    rows = int(math.sqrt(n_tri / 2))
    cols = (n_tri // 2) // max(rows, 1)
    th = torch.linspace(0.15, math.pi - 0.15, rows + 1, dtype=torch.float64,
                        device=dev)
    ph = torch.linspace(0, 2 * math.pi, cols + 1, dtype=torch.float64,
                        device=dev)
    T, P = torch.meshgrid(th, ph, indexing="ij")
    r = 1.0 + 0.05 * torch.randn(T.shape, generator=g_shape,
                                 dtype=torch.float64, device=dev)
    verts = torch.stack([r * torch.sin(T) * torch.cos(P), r * torch.cos(T),
                         r * torch.sin(T) * torch.sin(P)], -1).float()
    a, b = verts[:-1, :-1], verts[1:, :-1]
    c, d = verts[1:, 1:], verts[:-1, 1:]
    # per quad (i, j): triangles (a, b, c) then (a, c, d)
    tri_pos = torch.stack([torch.stack([a, b, c], -2),
                           torch.stack([a, c, d], -2)], 2)
    tri_pos = tri_pos.reshape(-1, 3, 3)[:n_tri].contiguous()
    fn = torch.linalg.cross(tri_pos[:, 1] - tri_pos[:, 0],
                            tri_pos[:, 2] - tri_pos[:, 0])
    fn = fn / (torch.linalg.vector_norm(fn, dim=-1, keepdim=True) + 1e-12)
    n = tri_pos.shape[0]
    return {
        "tri_pos": tri_pos,
        "tri_normal": fn[:, None].expand(n, 3, 3).contiguous(),
        "tri_tangent": torch.tensor([1.0, 0.0, 0.0, 1.0], device=dev)
        .expand(n, 3, 4).contiguous(),
        "tri_uv": (tri_pos[..., :2] * 0.25 + 0.5).contiguous(),
        "base_color_factor": torch.ones(4, device=dev),
        "metallic_factor": 1.0,
        "roughness_factor": 1.0,
        "base_color_tex": torch.rand((tex, tex, 4), generator=g, device=dev),
        "normal_tex": torch.clamp(
            0.5 + 0.1 * torch.randn((tex, tex, 3), generator=g, device=dev),
            0.0, 1.0),
        "metallic_roughness_tex": torch.rand((tex, tex, 3), generator=g,
                                             device=dev),
    }


def make_assets(config: dict, seed: int, device,
                fixed_shapes: bool = False) -> list:
    """The configuration's ``queue_assets`` assets of this run.
    ``fixed_shapes``: asset i has the same shape in every run (drawn from
    i), so that every seed gives the same set of sizes; its maps still
    come from the seed."""
    return [synth_asset(config["triangles"], config["texture_px"],
                        asset_seed(seed, i), device,
                        shape_seed=i if fixed_shapes else None)
            for i in range(config["queue_assets"])]
