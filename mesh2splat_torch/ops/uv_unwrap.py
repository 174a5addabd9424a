"""Normalized per-face UV unwrapping (counterpart of
``mesh2splat_tpu.ops.uv_unwrap``, the same numpy code): the capability
equivalent of the reference's xatlas-based ``generateNormalizedUvCoordinatesPerFace``
(reference: src/utils/normalizedUvUnwrapping.cpp:138-316 — shipped DISABLED,
call site commented out at SceneManager.cpp:29; conversion normally uses
on-the-fly triplanar UVs instead, which is also our default).

Like the reference's (CPU xatlas at load time), this runs host-side: each
triangle is isometrically flattened into its own chart and the charts are
shelf-packed into a normalized [0, 1]^2 atlas, giving every face a unique,
overlap-free region. Pass the result to ``ops.conversion.convert`` via
``ortho_uv`` to convert on the atlas grid instead of the triplanar
projection (one gaussian per covered atlas texel, no overlapping layers);
the port's ``convert`` takes it as a tensor.
"""

from __future__ import annotations

import numpy as np


def unwrap_normalized_uvs(
    tri_pos: np.ndarray,
    padding: float = 0.002,
    pack_efficiency: float = 0.65,
) -> np.ndarray:
    """tri_pos: (T, 3, 3) float32 world-space triangles.
    Returns (T, 3, 2) float32 normalized UVs in [0, 1]^2, one disjoint chart
    per triangle (area-preserving up to the global scale).

    padding: gutter between charts, in normalized units (pre-normalization
    it is scaled with the atlas).
    """
    tri_pos = np.asarray(tri_pos, np.float64)
    t = tri_pos.shape[0]
    if t == 0:
        return np.zeros((0, 3, 2), np.float32)

    p0, p1, p2 = tri_pos[:, 0], tri_pos[:, 1], tri_pos[:, 2]
    e1 = p1 - p0
    e2 = p2 - p0
    l1 = np.linalg.norm(e1, axis=-1)
    xhat = e1 / np.maximum(l1[:, None], 1e-30)
    x2 = np.einsum("ij,ij->i", e2, xhat)
    perp = e2 - x2[:, None] * xhat
    h = np.linalg.norm(perp, axis=-1)

    # chart-local coords: v0=(0,0), v1=(l1,0), v2=(x2,h); shift x >= 0
    x_min = np.minimum(0.0, x2)
    v0x, v1x, v2x = -x_min, l1 - x_min, x2 - x_min
    bw = np.maximum(np.maximum(v1x, v2x), v0x)  # chart width
    bh = h                                       # chart height

    # global scale so the shelf-packed atlas lands near [0, 1]^2
    area = np.sum(bw * bh)
    side = np.sqrt(max(area, 1e-30) / pack_efficiency)
    pad = padding * side

    # shelf packing, tallest first
    order = np.argsort(-bh, kind="stable")
    ox = np.zeros(t)
    oy = np.zeros(t)
    cx = 0.0
    cy = 0.0
    shelf_h = 0.0
    for i in order:
        w_i = bw[i] + pad
        if cx + w_i > side and cx > 0.0:
            cy += shelf_h + pad
            cx = 0.0
            shelf_h = 0.0
        ox[i] = cx
        oy[i] = cy
        cx += w_i
        shelf_h = max(shelf_h, bh[i])
    total_h = cy + shelf_h

    extent = max(side, total_h, 1e-30)
    uv = np.zeros((t, 3, 2))
    uv[:, 0, 0] = (ox + v0x) / extent
    uv[:, 1, 0] = (ox + v1x) / extent
    uv[:, 2, 0] = (ox + v2x) / extent
    uv[:, 0, 1] = oy / extent
    uv[:, 1, 1] = oy / extent
    uv[:, 2, 1] = (oy + bh) / extent
    return uv.astype(np.float32)
