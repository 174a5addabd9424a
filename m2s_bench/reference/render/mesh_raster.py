"""Triangle mesh rasterizer: the depth prepass and the mesh G-buffer
(counterpart of ``mesh2splat_tpu.render.mesh_raster``).

A z-buffered gather in plain PyTorch (the JAX package has no kernel here):
triangles are tested against every pixel in chunks of ``chunk``; each chunk
keeps its own per-pixel argmin of window depth (the first triangle among
equal depths) and replaces the running one only where strictly nearer, so
depth ties resolve as in the JAX package. The chunk loop holds
(chunk, H, W) temporaries: at 1080p and the default 64, about 530 MB each.
"""

from __future__ import annotations

import torch

from ..ops.sampling import sample_bilinear
from ..types import (
    Camera, Material, RenderMode, TriangleMesh, encode_normal,
    exponential_depth, resolve_device, to_device,
)
from .rasterize import OVERDRAW_RGBA


def _tri_random_color(tri_idx):
    """Per-triangle random colour (sin hashes of the triangle index). It
    follows the platform's sin, so it is not bit-identical across
    libraries."""
    t = tri_idx.to(torch.float32)

    def h(x):
        return torch.remainder(torch.sin(x) * 43758.5453, 1.0)

    return torch.stack([h(t * 311.7), h(t * 269.5 + 1.3), h(t * 183.3 + 2.7)],
                       dim=-1)


def _project_vertices(tri_pos, camera: Camera):
    """World -> clip -> NDC; also the clip w."""
    ones = torch.ones_like(tri_pos[..., :1])
    clip = torch.cat([tri_pos, ones], -1) @ (
        camera.view_to_clip @ camera.world_to_view).T
    w = clip[..., 3:4]
    w_safe = torch.where(w.abs() < 1e-12, 1e-12, w)
    return clip[..., :3] / w_safe, w[..., 0]


def _norm(v):
    return torch.linalg.vector_norm(v, dim=-1, keepdim=True)


@torch.no_grad()
def rasterize_mesh(mesh: TriangleMesh, material: Material, camera: Camera,
                   width: int, height: int, chunk: int = 64,
                   opaque_only: bool = False,
                   render_mode: RenderMode = RenderMode.ALBEDO,
                   device="cuda"):
    """(G-buffer dict, depth_ndc) on ``device`` (the inputs move there).

    The G-buffer has the five (H, W, 4) targets of the splat rasterizer
    plus transmittance; its albedo target carries the render mode's
    colouring (albedo, exponential depth, encoded normal, per-triangle
    colour or the overdraw constant). depth_ndc: (H, W) window depth in
    [0, 1] (1 where no triangle), row 0 at the top. opaque_only skips the
    mesh unless its base colour factor's alpha is 1 (the depth prepass)."""
    dev = resolve_device(device)
    mesh = to_device(mesh, dev)
    material = to_device(material, dev)
    camera = to_device(camera, dev)
    t = mesh.tri_pos.shape[0]
    ndc, w_clip = _project_vertices(mesh.tri_pos, camera)

    # window coordinates: x right, y up, pixel centres at +0.5
    sx = (ndc[..., 0] + 1.0) * 0.5 * width
    sy = (ndc[..., 1] + 1.0) * 0.5 * height
    sz = ndc[..., 2] * 0.5 + 0.5
    xs = torch.arange(width, dtype=torch.float32, device=dev) + 0.5
    ys = float(height) - (torch.arange(height, dtype=torch.float32,
                                       device=dev) + 0.5)
    px = xs[None, :].expand(height, width)
    py = ys[:, None].expand(height, width)
    draw = bool(material.base_color_factor[3] == 1.0) if opaque_only else True

    depth = torch.ones((height, width), dtype=torch.float32, device=dev)
    bary = torch.zeros((height, width, 3), dtype=torch.float32, device=dev)
    tri = torch.full((height, width), -1, dtype=torch.int64, device=dev)
    for c0 in range(0, t if draw else 0, chunk):
        sl = slice(c0, c0 + chunk)
        ax, ay = sx[sl, 0], sy[sl, 0]
        bx, by = sx[sl, 1], sy[sl, 1]
        cx, cy = sx[sl, 2], sy[sl, 2]

        def edge(x0, y0, x1, y1):
            return ((x1 - x0)[:, None, None] * (py[None] - y0[:, None, None])
                    - (y1 - y0)[:, None, None] * (px[None] - x0[:, None, None]))

        den = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
        den_safe = torch.where(den.abs() < 1e-12, 1e-12, den)[:, None, None]
        ba = edge(bx, by, cx, cy) / den_safe   # opposite a
        bb = edge(cx, cy, ax, ay) / den_safe   # opposite b
        bc = edge(ax, ay, bx, by) / den_safe   # opposite c
        # behind-camera triangles and degenerate ones are culled
        ok = ((ba >= 0) & (bb >= 0) & (bc >= 0)
              & (den.abs() > 1e-12)[:, None, None]
              & (w_clip[sl] > 0).all(dim=1)[:, None, None])
        z = (ba * sz[sl, 0, None, None] + bb * sz[sl, 1, None, None]
             + bc * sz[sl, 2, None, None])
        z = torch.where(ok & (z >= 0.0) & (z <= 1.0), z, float("inf"))

        local_min = z.amin(dim=0)
        local_arg = torch.argmin(z, dim=0)[None]
        take = local_min < depth
        new_bary = torch.stack([ba.gather(0, local_arg)[0],
                                bb.gather(0, local_arg)[0],
                                bc.gather(0, local_arg)[0]], dim=-1)
        depth = torch.where(take, local_min, depth)
        bary = torch.where(take[..., None], new_bary, bary)
        tri = torch.where(take, local_arg[0] + c0, tri)

    hit = tri >= 0
    tri_safe = torch.clamp(tri, min=0)
    bw = bary[..., None]                                   # (H, W, 3, 1)
    pos = (mesh.tri_pos[tri_safe] * bw).sum(dim=2)
    nrm = (mesh.tri_normal[tri_safe] * bw).sum(dim=2)
    nrm = nrm / (_norm(nrm) + 1e-12)
    uv = (mesh.tri_uv[tri_safe] * bw).sum(dim=2)

    if material.has_normal:
        # tangent-space normal mapping through the interpolated TBN frame
        tan4 = (mesh.tri_tangent[tri_safe] * bw).sum(dim=2)
        t_vec = tan4[..., :3]
        t_vec = t_vec / (_norm(t_vec) + 1e-12)
        b_vec = torch.linalg.cross(nrm, t_vec, dim=-1)
        b_vec = b_vec / (_norm(b_vec) + 1e-12)
        b_vec = b_vec * tan4[..., 3:4]
        mapped = sample_bilinear(material.normal, uv)[..., :3] * 2.0 - 1.0
        mapped = mapped / (_norm(mapped) + 1e-12)
        nrm = (mapped[..., 0:1] * t_vec + mapped[..., 1:2] * b_vec
               + mapped[..., 2:3] * nrm)
        nrm = nrm / (_norm(nrm) + 1e-12)

    if material.has_base_color:
        albedo = sample_bilinear(material.base_color, uv)
    else:
        albedo = torch.ones((height, width, 4), dtype=torch.float32,
                            device=dev)
    albedo = albedo * material.base_color_factor
    if material.has_metallic_roughness:
        mr = sample_bilinear(material.metallic_roughness, uv)
        pbr = torch.stack([mr[..., 2], mr[..., 1]], dim=-1)
    else:
        pbr = torch.tensor([0.1, 0.5], device=dev).expand(height, width, 2)

    hitf = hit.to(torch.float32)[..., None]
    one = torch.ones_like(hitf)
    view = torch.cat([pos, one], -1) @ camera.world_to_view.T
    view_depth = -view[..., 2]

    enc_n = encode_normal(nrm)
    mode = int(render_mode)
    if mode == int(RenderMode.DEPTH):
        out_color = exponential_depth(view_depth, camera.near,
                                      camera.far)[..., None].expand(-1, -1, 3)
    elif mode == int(RenderMode.NORMAL):
        out_color = enc_n
    elif mode == int(RenderMode.GEOMETRY):
        out_color = _tri_random_color(tri_safe)
    elif mode == int(RenderMode.OVERDRAW):
        out_color = pos.new_tensor(OVERDRAW_RGBA[:3]).expand_as(pos)
    else:  # ALBEDO / PBR / FINAL
        out_color = albedo[..., :3]

    gbuffer = {
        "albedo": torch.cat([out_color, one], -1) * hitf,
        "position": torch.cat([pos, one], -1) * hitf,
        "normal": torch.cat([enc_n, one], -1) * hitf,
        "depth": torch.cat([view_depth[..., None].expand(-1, -1, 3), one],
                           -1) * hitf,
        "metal_rough": torch.cat([pbr, torch.zeros_like(hitf), one], -1)
        * hitf,
        "transmittance": 1.0 - hitf[..., 0],
    }
    return gbuffer, depth

