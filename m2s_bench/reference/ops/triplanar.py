"""Triplanar ("orthogonal UV") projection + UV->3D Jacobian, per triangle
(counterpart of ``mesh2splat_tpu.ops.triplanar``; the reference's
converterGS.glsl:326-443 as dense per-triangle tensor math)."""

from __future__ import annotations

import torch

from .numerics import fma, sqrt
from .quat import mat_to_quat

EPS = 1e-12


def _norm(v, keepdim=False):
    """Euclidean norm over the last axis of length 3, with the reference's
    fused multiply-add chain (ops/numerics.py): the edge lengths and the
    normal decide the longest edge and the dominant axis."""
    sq = fma(v[..., 2], v[..., 2],
             fma(v[..., 1], v[..., 1], v[..., 0] * v[..., 0]))
    n = sqrt(sq)
    return n[..., None] if keepdim else n


def _cross(a, b):
    def d(i, j, k, m):
        return fma(a[..., i], b[..., j], -(a[..., k] * b[..., m]))

    return torch.stack([d(1, 2, 2, 1), d(2, 0, 0, 2), d(0, 1, 1, 0)], dim=-1)


def _reorder_longest_edge(v0, v1, v2):
    """edge1 <- the longest of (v1-v0, v2-v0, v2-v1); edge2 keeps/receives
    the displaced edge (converterGS.glsl:327-342)."""
    e1 = v1 - v0
    e2 = v2 - v0
    e3 = v2 - v1
    l1, l2, l3 = _norm(e1), _norm(e2), _norm(e3)
    swap2 = (l2 > l1) & (l2 > l3)
    swap3 = ~swap2 & (l3 > l1) & (l3 > l2)
    edge1 = torch.where(swap2[..., None], e2,
                        torch.where(swap3[..., None], e3, e1))
    edge2 = torch.where(swap2[..., None], e1, e2)
    return edge1, edge2


def triangle_frame(v0, v1, v2):
    edge1, edge2 = _reorder_longest_edge(v0, v1, v2)
    edge1 = edge1 / (_norm(edge1, keepdim=True) + EPS)
    n = _cross(edge1, edge2)
    n = n / (_norm(n, keepdim=True) + EPS)
    return edge1, n


def orthogonal_uv(pos, normal, bbox_min, bbox_max):
    """Triplanar projection to [0,1]^2, normalized by the longest in-plane
    bbox range (converterGS.glsl:349-399)."""
    an = normal.abs()
    ax, ay, az = an[..., 0], an[..., 1], an[..., 2]
    use_x = (ax > ay) & (ax > az)
    use_y = ~use_x & (ay > az)

    rng = bbox_max - bbox_min
    rel = pos - bbox_min

    range_x = torch.maximum(rng[..., 1], rng[..., 2])
    uv_x = torch.stack([rel[..., 1], rel[..., 2]], dim=-1) / (range_x[..., None] + EPS)
    range_y = torch.maximum(rng[..., 0], rng[..., 2])
    uv_y = torch.stack([rel[..., 0], rel[..., 2]], dim=-1) / (range_y[..., None] + EPS)
    range_z = torch.maximum(rng[..., 0], rng[..., 1])
    uv_z = torch.stack([rel[..., 0], rel[..., 1]], dim=-1) / (range_z[..., None] + EPS)

    return torch.where(use_x[..., None], uv_x,
                       torch.where(use_y[..., None], uv_y, uv_z))


def uv3d_jacobian(p0, p1, p2, uv0, uv1, uv2):
    """J = V * UV^-1: d(position)/d(uv), shape (..., 3, 2)."""
    du1 = uv1 - uv0
    du2 = uv2 - uv0
    a, b = du1[..., 0], du1[..., 1]
    c, d = du2[..., 0], du2[..., 1]
    det = a * d - c * b
    small = det.abs() < EPS
    safe_det = torch.where(small, 1.0, det)
    inv = torch.stack(
        [torch.stack([d, -c], dim=-1), torch.stack([-b, a], dim=-1)], dim=-2
    ) / safe_det[..., None, None]
    inv = torch.where(small[..., None, None], 0.0, inv)
    e1 = p1 - p0
    e2 = p2 - p0
    # V @ inv with V = [e1 e2] (3x2), written out per column
    col0 = e1 * inv[..., 0, 0, None] + e2 * inv[..., 1, 0, None]
    col1 = e1 * inv[..., 0, 1, None] + e2 * inv[..., 1, 1, None]
    return torch.stack([col0, col1], dim=-1)


def triangle_conversion_attrs(tri_pos, bbox_min, bbox_max, ouv_override=None):
    """All per-triangle conversion quantities: ortho_uv (T, 3, 2), quat
    (T, 4) wxyz, scale (T, 3), normal_geo (T, 3)."""
    v0, v1, v2 = tri_pos[:, 0], tri_pos[:, 1], tri_pos[:, 2]
    edge1, normal = triangle_frame(v0, v1, v2)

    if ouv_override is not None:
        ouv = ouv_override
    else:
        ouv = orthogonal_uv(tri_pos, normal[:, None, :], bbox_min, bbox_max)

    x_axis = edge1
    y_axis = _cross(normal, x_axis)
    y_axis = y_axis / (_norm(y_axis, keepdim=True) + EPS)
    z_axis = normal
    R = torch.stack([x_axis, y_axis, z_axis], dim=-1)  # columns
    quat = mat_to_quat(R)

    J = uv3d_jacobian(v0, v1, v2, ouv[:, 0], ouv[:, 1], ouv[:, 2])
    ju = _norm(J[..., 0])
    jv = _norm(J[..., 1])
    scale = torch.stack([ju, jv, torch.full_like(ju, 1e-7)], dim=-1)
    return {"ortho_uv": ouv, "quat": quat, "scale": scale, "normal_geo": normal}
