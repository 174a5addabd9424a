"""Quaternion / rotation utilities with the reference's conventions
(counterpart of ``mesh2splat_tpu.ops.quat``). Storage order is (w, x, y, z).
"""

from __future__ import annotations

import torch

from .numerics import sqrt


def quat_normalize(q, eps=1e-12):
    return q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + eps)


def quat_to_mat(q):
    """(..., 4) wxyz -> (..., 3, 3) standard rotation matrix (v' = R @ v)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def mat_to_quat(R):
    """(..., 3, 3) -> (..., 4) wxyz: branch-free GLM quat_cast (the
    reference's converterGS.glsl:131-183). GLSL m[i][j] == R[j, i]."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    g01, g02, g10 = m10, m20, m01
    g12, g20, g21 = m21, m02, m12

    four_x = m00 - m11 - m22
    four_y = m11 - m00 - m22
    four_z = m22 - m00 - m11
    four_w = m00 + m11 + m22

    cands = torch.stack([four_w, four_x, four_y, four_z], dim=-1)
    biggest_index = torch.argmax(cands, dim=-1)
    biggest = torch.amax(cands, dim=-1)
    biggest_val = sqrt(torch.clamp(biggest + 1.0, min=0.0)) * 0.5
    mult = 0.25 / torch.clamp(biggest_val, min=1e-20)

    q0 = torch.stack(
        [biggest_val, (g12 - g21) * mult, (g20 - g02) * mult, (g01 - g10) * mult],
        dim=-1,
    )
    q1 = torch.stack(
        [(g12 - g21) * mult, biggest_val, (g01 + g10) * mult, (g20 + g02) * mult],
        dim=-1,
    )
    q2 = torch.stack(
        [(g20 - g02) * mult, (g01 + g10) * mult, biggest_val, (g12 + g21) * mult],
        dim=-1,
    )
    q3 = torch.stack(
        [(g01 - g10) * mult, (g20 + g02) * mult, (g12 + g21) * mult, biggest_val],
        dim=-1,
    )
    stacked = torch.stack([q0, q1, q2, q3], dim=-2)  # (..., 4, 4)
    sel = biggest_index[..., None, None].expand(*biggest_index.shape, 1, 4)
    return torch.gather(stacked, -2, sel).squeeze(-2)


def quat_mul(q1, q2):
    """Hamilton product, wxyz order."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def covariance_from_quat_scale(q, s):
    """Sigma = R diag(s^2) R^T."""
    R = quat_to_mat(q)
    return torch.einsum("...ij,...j,...kj->...ik", R, s * s, R)
