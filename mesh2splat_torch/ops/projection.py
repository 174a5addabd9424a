"""EWA splat projection (counterpart of ``mesh2splat_tpu.ops.projection``):
one dense pass over all splats; culling becomes a validity mask. Formulas
as the reference's gaussianSplattingPrepassCS.glsl (Jacobian signs, +0.3
low-pass, closed-form 2x2 eigendecomposition, 1024 px axis clamp, 1.05*w
frustum margin)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .numerics import fma, sqrt
from ..types import (
    Camera, RenderMode, SplatFormat, Splats, encode_normal, exponential_depth,
)


@dataclasses.dataclass
class ProjectedSplats:
    """Per-splat screen-space quantities."""

    mean_ndc: torch.Tensor   # (N, 2)
    axes_px: torch.Tensor    # (N, 2, 2): [major, minor] half-axes in pixels
    conic: torch.Tensor      # (N, 3): inverse cov2d (a, b, c)
    depth: torch.Tensor      # (N,) positive view-space depth (-z_view)
    color: torch.Tensor      # (N, 4) render-mode-dependent rgba
    normal: torch.Tensor     # (N, 3) encoded normal in [0, 1]
    wspos: torch.Tensor      # (N, 3) world-space position
    pbr: torch.Tensor        # (N, 2) metallic, roughness
    valid: torch.Tensor      # (N,) bool

    @property
    def capacity(self):
        return self.mean_ndc.shape[0]


def axes_from_conic(ca, cb, cc):
    """3-sigma-clamped eigen half-axes (mjx, mjy, mnx, mny) of the 2D
    covariance, recovered from its inverse (the conic). Shared by
    projection and the composite's plain version; the composite kernel
    repeats it operation for operation (IEEE sqrt and 1/sqrt)."""
    det_c = ca * cc - cb * cb
    ok = det_c > 1e-30
    dsafe = torch.where(ok, det_c, 1.0)
    a = cc / dsafe
    b = -cb / dsafe
    c = ca / dsafe
    mid = a + c
    amc = a - c
    b2 = 2.0 * b
    delta = sqrt(amc * amc + b2 * b2)
    lam1 = 0.5 * (mid + delta)
    lam2 = 0.5 * (mid - delta)
    dv_den = b - c + lam1
    dv_den = torch.where(dv_den.abs() < 1e-12, 1e-12, dv_den)
    dvy = (-a + b + lam1) / dv_den
    rinv = 1.0 / sqrt(1.0 + dvy * dvy + 1e-24)
    dvx, dvy = rinv, dvy * rinv
    len1 = torch.clamp(3.0 * sqrt(torch.clamp(lam1, min=0.0)), max=1024.0)
    len2 = torch.clamp(3.0 * sqrt(torch.clamp(lam2, min=0.0)), max=1024.0)
    len1 = torch.where(ok, len1, 0.0)
    len2 = torch.where(ok, len2, 0.0)
    return len1 * dvx, len1 * dvy, len2 * dvy, -len2 * dvx


def _hash_random2d(co):
    """common.glsl random2d (fract(sin * k)), for GEOMETRY debug colouring.
    It follows the platform's sin, so it is not bit-identical across
    libraries."""
    dt = co[..., 0] * 12.9898 + co[..., 1] * 78.233
    sn = torch.remainder(dt, 3.14)
    return torch.remainder(torch.sin(sn) * 43758.5453, 1.0)


def project_splats(
    splats: Splats,
    camera: Camera,
    std_dev: float = 1.0,
    render_mode: RenderMode = RenderMode.ALBEDO,
    splat_format: SplatFormat = SplatFormat.MESH2SPLAT,
    has_pbr: bool = True,
    model_to_world: torch.Tensor | None = None,
    depth_map: torch.Tensor | None = None,
) -> ProjectedSplats:
    """Project all splats to screen space on the splats' device.
    Differentiable with respect to the splats' pos, color, scale, quat,
    normal and pbr; the camera's entries enter as Python floats."""
    if depth_map is not None:
        raise NotImplementedError(
            "mesh-occlusion culling (depth_map) needs the mesh rasterizer, "
            "which the port brings in its mesh-raster slice"
        )
    width, height = camera.width, camera.height
    # matrix entries as Python floats: each product below is f32 x f32
    P = camera.view_to_clip.tolist()
    V = camera.world_to_view.tolist()

    px, py, pz = splats.pos[:, 0], splats.pos[:, 1], splats.pos[:, 2]

    def affine(row, x, y, z):
        # row . (x, y, z, 1), fused as the reference's arithmetic fuses it
        return fma(row[2], z, fma(row[0], x, row[1] * y)) + row[3]

    identity_model = model_to_world is None
    if identity_model:
        M = np.eye(4, dtype=np.float32)
        wsx, wsy, wsz = px, py, pz
    else:
        M = model_to_world.detach().cpu().numpy().astype(np.float32)
        Ml = M.tolist()
        wsx, wsy, wsz = (affine(Ml[i], px, py, pz) for i in range(3))

    vsx, vsy, vsz = (affine(V[i], wsx, wsy, wsz) for i in range(3))
    cx, cy, cz, cw = (affine(P[i], vsx, vsy, vsz) for i in range(4))

    margin = 1.05 * cw
    inside = ((cz >= -margin) & (cx >= -margin) & (cx <= margin)
              & (cy >= -margin) & (cy <= margin))
    valid = splats.valid & inside

    # scale decode; model scale per column (|c0|, |c1|, |c2|)
    multiplier = std_dev if int(splat_format) in (0, 3) else 1.0
    model_scale = np.sqrt((M[:3, :3].astype(np.float32) ** 2).sum(axis=0))
    ms = [float(np.float32(v * v)) for v in model_scale]
    s0 = splats.scale[:, 0] * multiplier * ms[0]
    s1 = splats.scale[:, 1] * multiplier * ms[1]
    s2 = splats.scale[:, 2] * multiplier * ms[2]

    qw, qx, qy, qz = (splats.quat[:, 0], splats.quat[:, 1],
                      splats.quat[:, 2], splats.quat[:, 3])
    r00 = 1.0 - 2.0 * (qy * qy + qz * qz)
    r01 = 2.0 * (qx * qy - qw * qz)
    r02 = 2.0 * (qx * qz + qw * qy)
    r10 = 2.0 * (qx * qy + qw * qz)
    r11 = 1.0 - 2.0 * (qx * qx + qz * qz)
    r12 = 2.0 * (qy * qz - qw * qx)
    r20 = 2.0 * (qx * qz - qw * qy)
    r21 = 2.0 * (qy * qz + qw * qx)
    r22 = 1.0 - 2.0 * (qy * qy + qx * qx)

    if not identity_model:
        mr = (M[:3, :3] / np.maximum(model_scale, 1e-12)).astype(np.float32)
        mr = mr.tolist()
        r00, r10, r20 = (
            mr[0][0] * r00 + mr[0][1] * r10 + mr[0][2] * r20,
            mr[1][0] * r00 + mr[1][1] * r10 + mr[1][2] * r20,
            mr[2][0] * r00 + mr[2][1] * r10 + mr[2][2] * r20,
        )
        r01, r11, r21 = (
            mr[0][0] * r01 + mr[0][1] * r11 + mr[0][2] * r21,
            mr[1][0] * r01 + mr[1][1] * r11 + mr[1][2] * r21,
            mr[2][0] * r01 + mr[2][1] * r11 + mr[2][2] * r21,
        )
        r02, r12, r22 = (
            mr[0][0] * r02 + mr[0][1] * r12 + mr[0][2] * r22,
            mr[1][0] * r02 + mr[1][1] * r12 + mr[1][2] * r22,
            mr[2][0] * r02 + mr[2][1] * r12 + mr[2][2] * r22,
        )

    def dot3(a0, b0, a1, b1, a2, b2):
        # a0*b0 + a1*b1 + a2*b2, fused as the reference's arithmetic fuses it
        return fma(a2, b2, fma(a0, b0, a1 * b1))

    # cov3d = R S^2 R^T (6 unique entries)
    q0, q1, q2 = s0 * s0, s1 * s1, s2 * s2
    c00 = dot3(r00 * r00, q0, r01 * r01, q1, r02 * r02, q2)
    c01 = dot3(r00 * r10, q0, r01 * r11, q1, r02 * r12, q2)
    c02 = dot3(r00 * r20, q0, r01 * r21, q1, r02 * r22, q2)
    c11 = dot3(r10 * r10, q0, r11 * r11, q1, r12 * r12, q2)
    c12 = dot3(r10 * r20, q0, r11 * r21, q1, r12 * r22, q2)
    c22 = dot3(r20 * r20, q0, r21 * r21, q1, r22 * r22, q2)

    # EWA Jacobian; z_view is negative in front of the camera
    z_safe = torch.where(vsz.abs() < 1e-8, -1e-8, vsz)
    p00, p11 = P[0][0], P[1][1]
    jsx = -(p00 * width) / (2.0 * z_safe)
    jsy = -(p11 * height) / (2.0 * z_safe)
    jtx = (p00 * vsx * width) / (2.0 * z_safe * z_safe)
    jty = (p11 * vsy * height) / (2.0 * z_safe * z_safe)

    u0 = fma(jsx, V[0][0], jtx * V[2][0])
    u1 = fma(jsx, V[0][1], jtx * V[2][1])
    u2 = fma(jsx, V[0][2], jtx * V[2][2])
    v0 = fma(jsy, V[1][0], jty * V[2][0])
    v1 = fma(jsy, V[1][1], jty * V[2][1])
    v2 = fma(jsy, V[1][2], jty * V[2][2])

    cu0 = dot3(c00, u0, c01, u1, c02, u2)
    cu1 = dot3(c01, u0, c11, u1, c12, u2)
    cu2 = dot3(c02, u0, c12, u1, c22, u2)
    a = dot3(u0, cu0, u1, cu1, u2, cu2) + 0.3
    b = dot3(v0, cu0, v1, cu1, v2, cu2)
    cv0 = dot3(c00, v0, c01, v1, c02, v2)
    cv1 = dot3(c01, v0, c11, v1, c12, v2)
    cv2 = dot3(c02, v0, c12, v1, c22, v2)
    c = dot3(v0, cv0, v1, cv1, v2, cv2) + 0.3

    mid = a + c
    amc = a - c
    b2 = 2.0 * b
    delta = sqrt(fma(amc, amc, b2 * b2))
    lam2 = 0.5 * (mid - delta)
    valid = valid & (lam2 >= 0.0)

    det = fma(a, c, -(b * b))
    det_ok = det.abs() >= 1e-20
    det_safe = torch.where(det_ok, det, 1.0)
    conic = torch.stack([
        torch.where(det_ok, c / det_safe, 0.0),
        torch.where(det_ok, -b / det_safe, 0.0),
        torch.where(det_ok, a / det_safe, 0.0),
    ], dim=-1)
    mjx, mjy, mnx, mny = axes_from_conic(conic[:, 0], conic[:, 1], conic[:, 2])
    axes_px = torch.stack([mjx, mjy, mnx, mny], dim=-1).reshape(-1, 2, 2)

    w_safe = torch.where(cw.abs() < 1e-12, 1e-12, cw)
    mean_ndc = torch.stack([cx / w_safe, cy / w_safe], dim=-1)
    depth = -vsz
    ws = torch.stack([wsx, wsy, wsz], dim=-1)

    if identity_model:
        n_ws = splats.normal
    else:
        normal_mat = np.linalg.inv(M).T[:3, :3].astype(np.float32)
        n_ws = splats.normal @ torch.from_numpy(normal_mat.T.copy()).to(
            splats.normal.device)
    use_mesh_normal = int(splat_format) in (0, 3) or (
        int(splat_format) == 1 and has_pbr)
    if use_mesh_normal:
        normal_enc = encode_normal(n_ws)
    else:
        # shortest-covariance-axis normal (a column of R)
        min_idx = torch.argmin(splats.scale, dim=-1)
        ax0 = torch.stack([r00, r10, r20], dim=-1)
        ax1 = torch.stack([r01, r11, r21], dim=-1)
        ax2 = torch.stack([r02, r12, r22], dim=-1)
        axis = torch.where((min_idx == 0)[:, None], ax0,
                           torch.where((min_idx == 1)[:, None], ax1, ax2))
        normal_enc = encode_normal(axis)

    expdepth = exponential_depth(depth, camera.near, camera.far)
    alpha = splats.color[:, 3:4]
    mode = int(render_mode)
    if mode == 1:
        color = torch.cat([expdepth[:, None].expand(-1, 3), alpha], dim=-1)
    elif mode == 2:
        color = torch.cat([normal_enc, alpha], dim=-1)
    elif mode == 3:
        gid = torch.arange(splats.capacity, dtype=torch.float32,
                           device=splats.pos.device)
        co = torch.stack([torch.remainder(gid, 4096.0),
                          torch.div(gid, 4096.0, rounding_mode="floor")],
                         dim=-1)
        color = torch.stack([
            _hash_random2d(co), _hash_random2d(co.flip(-1)),
            _hash_random2d(co.flip(-1) * 1.234), torch.ones_like(gid),
        ], dim=-1)
    else:  # ALBEDO, FINAL, and the downstream OVERDRAW / PBR modes
        color = splats.color

    return ProjectedSplats(
        mean_ndc=mean_ndc, axes_px=axes_px, conic=conic, depth=depth,
        color=color, normal=normal_enc, wspos=ws, pbr=splats.pbr, valid=valid,
    )
