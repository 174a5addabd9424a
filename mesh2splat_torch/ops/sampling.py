"""Bilinear texture sampling with GL_REPEAT wrap (counterpart of
``mesh2splat_tpu.ops.sampling.sample_bilinear``; the mesh rasterizer's
texture lookups). Conversion samples through its tap atlas instead."""

from __future__ import annotations

import torch


def sample_bilinear(tex: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """tex: (H, W, C); uv: (..., 2) with REPEAT wrap. Texel (i, j) has its
    centre at uv = ((j + 0.5) / W, (i + 0.5) / H); v maps straight to the
    row index (textures are not flipped). Returns (..., C)."""
    h, w = tex.shape[0], tex.shape[1]
    u = uv[..., 0] * w - 0.5
    v = uv[..., 1] * h - 0.5
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]
    u0i = torch.remainder(u0.to(torch.int32), w).long()
    u1i = torch.remainder(u0i + 1, w)
    v0i = torch.remainder(v0.to(torch.int32), h).long()
    v1i = torch.remainder(v0i + 1, h)
    t00 = tex[v0i, u0i]
    t01 = tex[v0i, u1i]
    t10 = tex[v1i, u0i]
    t11 = tex[v1i, u1i]
    return (t00 * (1 - fu) * (1 - fv) + t01 * fu * (1 - fv)
            + t10 * (1 - fu) * fv + t11 * fu * fv)
