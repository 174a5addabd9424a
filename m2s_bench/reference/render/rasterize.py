"""Dense splat rasterizer (counterpart of
``mesh2splat_tpu.render.rasterize``): the ground truth of the tiled path.

Every splat is tested against every pixel: a global front-to-back order
(stable sort on view depth, invalid splats last), the quad's parallelogram
coverage |u|, |v| <= 1 in its (major, minor) axis basis, the falloff
exp(-0.5 d^T Conic d), and front-to-back "under" compositing with one
transmittance per alpha group (albedo / normal / depth accumulate alpha*g,
position / metal-rough accumulate g). Chunks of 256 splats are composited
in turn, as the JAX package's ``scan`` does, so memory stays bounded. Plain
PyTorch, differentiable through autograd; the JAX package has no kernel
here.
"""

from __future__ import annotations

import torch

from ..ops.projection import ProjectedSplats
from ..types import RenderMode, resolve_device, to_device

OVERDRAW_RGBA = (0.01, 0.005, 0.0, 0.01)


def _pixel_centers(width, height, device):
    """GL window coordinates of the pixel centres, (H, W) each, row 0 at
    the top of the image."""
    xs = torch.arange(width, dtype=torch.float32, device=device) + 0.5
    ys = float(height) - (torch.arange(height, dtype=torch.float32,
                                       device=device) + 0.5)
    return (xs[None, :].expand(height, width),
            ys[:, None].expand(height, width))


def splat_chunk_contribution(mean_px, axes_px, conic, px, py):
    """Falloff g (K, H, W) of a chunk of splats over all pixels, zero
    outside each quad. mean_px (K, 2); axes_px (K, 2, 2); conic (K, 3)."""
    dx = mean_px[:, 0, None, None] - px[None]
    dy = mean_px[:, 1, None, None] - py[None]
    mj = axes_px[:, 0]
    mn = axes_px[:, 1]
    det = mj[:, 0] * mn[:, 1] - mn[:, 0] * mj[:, 1]
    det_safe = torch.where(det.abs() < 1e-12, 1e-12, det)
    rdet = (1.0 / det_safe)[:, None, None]
    fx = -dx
    fy = -dy
    u = (fx * mn[:, 1, None, None] - mn[:, 0, None, None] * fy) * rdet
    v = (mj[:, 0, None, None] * fy - fx * mj[:, 1, None, None]) * rdet
    inside = (u.abs() <= 1.0) & (v.abs() <= 1.0)
    power = -(0.5 * conic[:, 0, None, None] * dx * dx
              + conic[:, 1, None, None] * dx * dy
              + 0.5 * conic[:, 2, None, None] * dy * dy)
    g = torch.exp(torch.minimum(power, torch.zeros_like(power)))
    return torch.where(inside, g, 0.0)


def _excl_cumprod(x):
    """Exclusive product along dim 0."""
    return torch.cat([torch.ones_like(x[:1]), torch.cumprod(x, dim=0)[:-1]])


def rasterize_dense(proj: ProjectedSplats, width: int, height: int,
                    render_mode: RenderMode = RenderMode.ALBEDO,
                    chunk: int = 256, device="cuda"):
    """The 5-target G-buffer: albedo, position, normal, depth, metal_rough
    (H, W, 4) premultiplied accumulations, plus transmittance (H, W), on
    ``device`` (the projection moves there)."""
    dev = resolve_device(device)
    proj = to_device(proj, dev)
    order = torch.argsort(
        torch.where(proj.valid, proj.depth, torch.inf).detach(), stable=True)
    mean_px = (proj.mean_ndc[order] + 1.0) * torch.tensor(
        [width * 0.5, height * 0.5], dtype=torch.float32, device=dev)
    axes_px = proj.axes_px[order]
    conic = proj.conic[order]
    color = proj.color[order]
    normal = proj.normal[order]
    wspos = proj.wspos[order]
    pbr = proj.pbr[order]
    depth = proj.depth[order]
    valid = proj.valid[order]
    alpha = torch.where(valid, color[:, 3], 0.0)
    px, py = _pixel_centers(width, height, dev)
    overdraw = int(render_mode) == int(RenderMode.OVERDRAW)

    zeros = torch.zeros((height, width, 4), dtype=torch.float32, device=dev)
    acc = {k: zeros for k in ("albedo", "position", "normal", "depth",
                              "metal_rough")}
    t_a = torch.ones((height, width), dtype=torch.float32, device=dev)
    t_g = torch.ones_like(t_a)

    for c0 in range(0, proj.capacity, chunk):
        sl = slice(c0, c0 + chunk)
        g = splat_chunk_contribution(mean_px[sl], axes_px[sl], conic[sl],
                                     px, py)
        g = torch.where(valid[sl, None, None], g, 0.0)  # (K, H, W)
        if overdraw:
            cover = (g > 0.0).to(torch.float32)
            acc["albedo"] = acc["albedo"] + torch.einsum(
                "khw,c->hwc", cover,
                torch.tensor(OVERDRAW_RGBA, dtype=torch.float32, device=dev))
            continue
        a = alpha[sl, None, None]
        ag = a * g
        one_m_ag = 1.0 - ag
        one_m_g = 1.0 - g
        w_a = t_a[None] * _excl_cumprod(one_m_ag)
        w_g = t_g[None] * _excl_cumprod(one_m_g)
        gg = g[..., None]
        ag4 = ag[..., None]

        def under(dst, src, w):
            return dst + torch.einsum("khwc,khw->hwc", src, w)

        src_albedo = torch.cat(
            [color[sl, None, None, :3] * a[..., None] * gg, ag4], dim=-1)
        src_pos = torch.cat([wspos[sl, None, None, :] * gg, gg], dim=-1)
        src_nrm = torch.cat([normal[sl, None, None, :] * gg, ag4], dim=-1)
        src_dep = torch.cat(
            [(depth[sl, None, None] * g)[..., None].expand(-1, -1, -1, 3),
             ag4], dim=-1)
        src_mr = torch.cat([pbr[sl, None, None, :] * gg,
                            torch.zeros_like(gg), gg], dim=-1)
        acc = {
            "albedo": under(acc["albedo"], src_albedo, w_a),
            "position": under(acc["position"], src_pos, w_g),
            "normal": under(acc["normal"], src_nrm, w_a),
            "depth": under(acc["depth"], src_dep, w_a),
            "metal_rough": under(acc["metal_rough"], src_mr, w_g),
        }
        t_a = t_a * torch.prod(one_m_ag, dim=0)
        t_g = t_g * torch.prod(one_m_g, dim=0)

    out = dict(acc)
    out["transmittance"] = t_a
    return out
