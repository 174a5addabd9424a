"""Bilinear texture sampling with GL_REPEAT wrap (counterpart of
``mesh2splat_tpu.ops.sampling``): direct sampling, nearest sampling and the
tap-atlas layouts (one gather per call: a row per texel holding its 2x2
footprint, layered for several materials, or a row per block of texels).
The mesh rasterizer samples directly; conversion samples through its own
packed atlas (``ops.fragment``)."""

from __future__ import annotations

import torch


def _footprint(uv, h, w):
    """The footprint's top-left texel (row, column), int64, and its
    fractions (..., 1): texel (i, j) has its centre at uv = ((j + 0.5) / W,
    (i + 0.5) / H)."""
    u = uv[..., 0] * w - 0.5
    v = uv[..., 1] * h - 0.5
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]
    u0i = torch.remainder(u0.to(torch.int32), w).long()
    v0i = torch.remainder(v0.to(torch.int32), h).long()
    return v0i, u0i, fv, fu


def _lerp4(t00, t01, t10, t11, fu, fv):
    return (t00 * (1 - fu) * (1 - fv) + t01 * fu * (1 - fv)
            + t10 * (1 - fu) * fv + t11 * fu * fv)


def sample_bilinear(tex: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """tex: (H, W, C); uv: (..., 2) with REPEAT wrap; v maps straight to
    the row index (textures are not flipped). Returns (..., C)."""
    h, w = tex.shape[0], tex.shape[1]
    v0i, u0i, fv, fu = _footprint(uv, h, w)
    u1i = torch.remainder(u0i + 1, w)
    v1i = torch.remainder(v0i + 1, h)
    return _lerp4(tex[v0i, u0i], tex[v0i, u1i], tex[v1i, u0i], tex[v1i, u1i],
                  fu, fv)


def sample_nearest(tex: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    h, w = tex.shape[0], tex.shape[1]
    ui = torch.remainder(torch.floor(uv[..., 0] * w).to(torch.int32), w)
    vi = torch.remainder(torch.floor(uv[..., 1] * h).to(torch.int32), h)
    return tex[vi.long(), ui.long()]


def build_tap_atlas(tex: torch.Tensor) -> torch.Tensor:
    """(H, W, C) -> (H*W, 4C) rows [t00, t01, t10, t11] of each texel's 2x2
    bilinear footprint, REPEAT wrap. Differentiable (rolls and a cat)."""
    h, w, c = tex.shape
    t01 = torch.roll(tex, -1, dims=1)
    t10 = torch.roll(tex, -1, dims=0)
    t11 = torch.roll(t10, -1, dims=1)
    return torch.cat([tex, t01, t10, t11], dim=-1).reshape(h * w, 4 * c)


def _split4(rows, c):
    return (rows[..., 0 * c:1 * c], rows[..., 1 * c:2 * c],
            rows[..., 2 * c:3 * c], rows[..., 3 * c:4 * c])


def sample_bilinear_atlas(atlas: torch.Tensor, h: int, w: int, c: int,
                          uv: torch.Tensor) -> torch.Tensor:
    """Bilinear sample through a tap atlas: one gather per call."""
    v0i, u0i, fv, fu = _footprint(uv, h, w)
    return _lerp4(*_split4(atlas[v0i * w + u0i], c), fu, fv)


def build_tap_atlas_layered(tex: torch.Tensor) -> torch.Tensor:
    """Layered tap atlas of a (M, H, W, C) texture array (one material a
    layer, REPEAT wrap within each layer): (M*H*W, 4C) rows."""
    m, h, w, c = tex.shape
    t01 = torch.roll(tex, -1, dims=2)
    t10 = torch.roll(tex, -1, dims=1)
    t11 = torch.roll(t10, -1, dims=2)
    return torch.cat([tex, t01, t10, t11], dim=-1).reshape(m * h * w, 4 * c)


def sample_bilinear_atlas_layered(atlas, h, w, c, uv, layer):
    """Bilinear sample of layer ``layer`` (an integer per row) through a
    layered tap atlas: one gather for a whole multi-material batch."""
    v0i, u0i, fv, fu = _footprint(uv, h, w)
    rows = atlas[layer.long() * (h * w) + v0i * w + u0i]
    return _lerp4(*_split4(rows, c), fu, fv)


def build_block_atlas(tex: torch.Tensor, block: int = 4) -> torch.Tensor:
    """Blocked tap atlas: one row per (block x block) tile of texels,
    holding its (block+1)^2 window (a one-texel halo right and down, REPEAT
    wrap), so that every footprint starting in the tile lies in the row:
    (H/block * W/block, (block+1)^2 * C)."""
    h, w, c = tex.shape
    if h % block or w % block:
        raise ValueError(f"texture {h}x{w} is no multiple of block {block}")
    hb, wb = h // block, w // block
    taps = []
    for dv in range(block + 1):
        for du in range(block + 1):
            t = torch.roll(torch.roll(tex, -dv, dims=0), -du, dims=1)
            taps.append(t.reshape(hb, block, wb, block, c)[:, 0, :, 0, :])
    return torch.stack(taps, dim=2).reshape(hb * wb, (block + 1) ** 2 * c)


def sample_bilinear_block_atlas(atlas, h, w, c, uv, block: int = 4):
    """Bilinear sample through a blocked tap atlas: one gather of the
    window, the footprint's corners picked from it by one-hot contractions
    (exact: one product by 1, the rest by 0)."""
    wb = w // block
    v0i, u0i, fv, fu = _footprint(uv, h, w)
    bu, lu = u0i // block, u0i % block
    bv, lv = v0i // block, v0i % block
    rows = atlas[bv * wb + bu]
    win = rows.reshape(*rows.shape[:-1], block + 1, block + 1, c)
    iu = torch.arange(block + 1, device=uv.device)
    ohu0 = (lu[..., None] == iu).to(win.dtype)
    ohu1 = (lu[..., None] + 1 == iu).to(win.dtype)
    ohv0 = (lv[..., None] == iu).to(win.dtype)
    ohv1 = (lv[..., None] + 1 == iu).to(win.dtype)

    def pick(ohv, ohu):
        return torch.einsum("...vuc,...v,...u->...c", win, ohv, ohu)

    return _lerp4(pick(ohv0, ohu0), pick(ohv0, ohu1), pick(ohv1, ohu0),
                  pick(ohv1, ohu1), fu, fv)
