"""Omnidirectional (cubemap) splat shadows and PCF sampling (counterpart of
``mesh2splat_tpu.render.shadows``).

Each splat belongs to the cubemap face of its dominant light-space
direction; its quad is projected with the EWA math against that face's
90-degree camera, and a face stores the minimum radial distance
|ws - light| / far over the quads that cover a pixel (1.0 where none does).

``method="tiled"`` projects every splat once against its own face
(``_shadow_prep_fused``), stacks the six faces as row bands of one
(6*size, size) image, bins the pairs with a per-splat band scissor and
takes the per-pixel minimum with kernel K5 (``composite.min_depth_tiles``).
``method="dense"`` projects the splats six times through
``ops.projection.project_splats`` and tests every (splat, pixel) in plain
PyTorch. ``method="auto"`` takes the tiled path for faces of 512 or more
pixels or more than 65,536 splats.

PCF: a 20-tap disk kernel, bias 0.05, disk radius 0.025.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.numerics import fma, sqrt
from ..ops.projection import (
    ProjectedSplats, axes_from_conic, model_frame, project_splats,
    rotation_columns, screen_conic,
)
from ..types import (
    Camera, SplatFormat, Splats, look_at, perspective, resolve_device,
    to_device,
)
from ..utils.profiling import annotate
from . import binning as B
from . import composite as C

# GL cubemap face order: +X, -X, +Y, -Y, +Z, -Z
_FACE_DIRS = np.array(
    [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
    np.float32,
)
_FACE_UPS = np.array(
    [[0, -1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1], [0, -1, 0], [0, -1, 0]],
    np.float32,
)
# the face rotations (look_at of the axis directions): every entry is 0 or
# +-1, so a rotated vector's components are exact
_FACE_ROT = np.stack([look_at(np.zeros(3), _FACE_DIRS[f], _FACE_UPS[f])[:3, :3]
                      for f in range(6)])

_PCF_OFFSETS = np.array(
    [
        [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1],
        [1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
        [1, 1, 0], [1, -1, 0], [-1, -1, 0], [-1, 1, 0],
        [1, 0, 1], [-1, 0, 1], [1, 0, -1], [-1, 0, -1],
        [0, 1, 1], [0, -1, 1], [0, -1, -1], [0, 1, -1],
    ],
    np.float32,
)

_NEAR, _FAR_PLANE = 0.1, 1e4   # the face cameras' clip planes


@dataclasses.dataclass
class ShadowCubemap:
    """6 x (S, S) minimum radial-distance maps, values in [0, 1] (x far)."""

    faces: torch.Tensor      # (6, S, S) f32
    light_pos: torch.Tensor  # (3,)
    far: torch.Tensor        # scalar

    @property
    def resolution(self):
        return self.faces.shape[1]


def face_cameras(light_pos, far, size: int, near: float = _NEAR):
    """The six 90-degree cameras at ``light_pos`` (a (3,) tensor), in GL
    face order."""
    proj = torch.from_numpy(perspective(np.pi / 2, 1.0, near, _FAR_PLANE))
    cams = []
    for f in range(6):
        m = torch.from_numpy(look_at(np.zeros(3), _FACE_DIRS[f],
                                     _FACE_UPS[f])).to(light_pos.device)
        m[:3, 3] = -(m[:3, :3] @ light_pos)
        cams.append(Camera(world_to_view=m,
                           view_to_clip=proj.to(light_pos.device),
                           near=float(np.float32(near)),
                           far=float(np.float32(_FAR_PLANE)),
                           width=size, height=size))
    return cams


def dominant_face(d):
    """Face index 0..5 (GL order) of each direction's dominant component.
    d: (..., 3) -> int32."""
    axis = torch.argmax(d.abs(), dim=-1)
    comp = torch.gather(d, -1, axis[..., None])[..., 0]
    return (axis * 2 + (comp < 0).to(axis.dtype)).to(torch.int32)


def _world_pos(splats: Splats, model_to_world):
    """Splat centres in world space (faces are assigned after the model
    matrix)."""
    if model_to_world is None:
        return splats.pos
    M = model_to_world.to(splats.pos)
    return splats.pos @ M[:3, :3].T + M[:3, 3]


def _norm3(d):
    """|d| over the last axis, the squares summed in order with the fused
    multiply-adds of the reference's reduction."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    return sqrt(fma(z, z, fma(y, y, x * x)))


def _shadow_prep(splats: Splats, light_pos, far, std_dev, size: int,
                 model_to_world=None,
                 splat_format: SplatFormat = SplatFormat.MESH2SPLAT):
    """The dense path's prep: radial depths and the six face projections,
    each of the splats whose dominant direction is that face."""
    ws = _world_pos(splats, model_to_world)
    splat_face = dominant_face(ws - light_pos)
    radial = _norm3(ws - light_pos) / far
    projs = []
    for f, cam in enumerate(face_cameras(light_pos, far, size)):
        in_face = splats.valid & (splat_face == f)
        projs.append(project_splats(
            dataclasses.replace(splats, valid=in_face), cam, std_dev=std_dev,
            splat_format=splat_format, model_to_world=model_to_world))
    return radial, projs


def _shadow_prep_fused(splats: Splats, light_pos, far, std_dev, size: int,
                       model_to_world=None,
                       splat_format: SplatFormat = SplatFormat.MESH2SPLAT):
    """One projection of every splat against its own face (the dominant
    direction from the light): the per-splat face rotation W picked from
    the six constant ones, then ops/projection.py's EWA math. Face f's
    viewport is the row band [f*size, (f+1)*size) of a (6*size, size) tall
    image. Returns the merged ProjectedSplats (depth = radial distance /
    far), the per-splat tile-row band (ty_lo, ty_hi) and the class-C pair
    need of the band-clamped binning."""
    n = splats.capacity
    dev = splats.pos.device
    ws = _world_pos(splats, model_to_world)
    d = ws - light_pos
    splat_face = dominant_face(d)
    radial = _norm3(d) / far

    # the splat's face rotation, gathered from the six constants (the JAX
    # package selects it with a one-hot product, which picks the same
    # values)
    w = torch.from_numpy(_FACE_ROT.reshape(6, 9)).to(dev)[splat_face.long()]
    w00, w01, w02, w10, w11, w12, w20, w21, w22 = w.unbind(1)

    # the shared 90-degree projection: p00 = p11 = 1, so cx = vsx, cy = vsy
    p22 = float(np.float32(-(_FAR_PLANE + _NEAR) / (_FAR_PLANE - _NEAR)))
    p23 = float(np.float32(-2.0 * _FAR_PLANE * _NEAR / (_FAR_PLANE - _NEAR)))
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    vsx = w00 * dx + w01 * dy + w02 * dz
    vsy = w10 * dx + w11 * dy + w12 * dz
    vsz = w20 * dx + w21 * dy + w22 * dz
    cx, cy = vsx, vsy
    cz = fma(vsz, p22, p23)
    cw = -vsz

    # frustum cull at 1.05 w: the dominant face keeps |cx|, |cy| <= w, so
    # this mainly rejects splats at the light
    margin = 1.05 * cw
    inside = ((cz >= -margin) & (cx >= -margin) & (cx <= margin)
              & (cy >= -margin) & (cy <= margin))
    valid = splats.valid & inside

    _, ms, mr = model_frame(model_to_world)
    mult = std_dev if int(splat_format) in (0, 3) else 1.0
    s = [splats.scale[:, i] * mult * ms[i] for i in range(3)]
    r = rotation_columns(splats.quat, mr)

    # EWA Jacobian with the face rotation as W; the products with W's
    # entries (0 or +-1) are exact
    z_safe = torch.where(vsz.abs() < 1e-8, -1e-8, vsz)
    jsx = -float(size) / (2.0 * z_safe)
    jsy = jsx
    jtx = (vsx * size) / (2.0 * z_safe * z_safe)
    jty = (vsy * size) / (2.0 * z_safe * z_safe)
    u = (jsx * w00 + jtx * w20, jsx * w01 + jtx * w21, jsx * w02 + jtx * w22)
    v = (jsy * w10 + jty * w20, jsy * w11 + jty * w21, jsy * w12 + jty * w22)
    lam2_ok, conic = screen_conic(r, s, u, v)
    valid = valid & lam2_ok
    mjx, mjy, mnx, mny = axes_from_conic(conic[:, 0], conic[:, 1], conic[:, 2])
    axes_px = torch.stack([mjx, mjy, mnx, mny], dim=-1).reshape(-1, 2, 2)

    # face-local window y -> the tall image's: row band 5 - f from the
    # bottom, re-expressed in the tall image's ndc (height 6 * size); the
    # reference divides by 6 and 3 as products with their f32 reciprocals
    w_safe = torch.where(cw.abs() < 1e-12, 1e-12, cw)
    facef = splat_face.to(torch.float32)
    ndc_y = (((cy / w_safe + 1.0) * float(np.float32(1.0 / 6.0))
              + (5.0 - facef) * float(np.float32(1.0 / 3.0))) - 1.0)
    mean_ndc = torch.stack([cx / w_safe, ndc_y], dim=1)

    zeros = torch.zeros((n, 4), dtype=torch.float32, device=dev)
    merged = ProjectedSplats(
        mean_ndc=mean_ndc, axes_px=axes_px, conic=conic, depth=radial,
        color=zeros, normal=zeros[:, :3], wspos=ws, pbr=zeros[:, :2],
        valid=valid)
    tiles_per_face = size // B.TILE_H
    ty_lo = splat_face * tiles_per_face
    band = (ty_lo, ty_lo + (tiles_per_face - 1))
    need = B.required_overflow(merged, size, 6 * size, band)
    return merged, band, need


def _fused_min_raster(merged, band, size: int, pair_capacity: int):
    """One band-clamped binning and one min-depth walk (K5 on the card) for
    all six faces. Returns (6, size, size), 1.0 (= far) where uncovered."""
    h = 6 * size
    binned = B.bin_pairs(merged, size, h, pair_capacity, variant="depth",
                         band_ty=band)
    ty, tx = B.tiles_for(size, h)
    out = C.min_depth_tiles(binned, h, ty, tx)
    depth = out[0, :h, :size].reshape(6, size, size)
    return torch.where(depth > 1e37, 1.0, depth)


def _min_rasterize_face(proj, radial, size: int, chunk: int):
    """Per-pixel minimum radial depth over the covering quad
    parallelograms of one face, every (splat, pixel) tested."""
    dev = radial.device
    mean_px = (proj.mean_ndc + 1.0) * (size * 0.5)
    xs = torch.arange(size, dtype=torch.float32, device=dev) + 0.5
    ys = float(size) - (torch.arange(size, dtype=torch.float32, device=dev)
                        + 0.5)
    px = xs[None, :].expand(size, size)
    py = ys[:, None].expand(size, size)
    depth = torch.full((size, size), float("inf"), device=dev)
    for c0 in range(0, proj.capacity, chunk):
        sl = slice(c0, c0 + chunk)
        fx = px[None] - mean_px[sl, 0, None, None]
        fy = py[None] - mean_px[sl, 1, None, None]
        mj = proj.axes_px[sl, 0]
        mn = proj.axes_px[sl, 1]
        det = mj[:, 0] * mn[:, 1] - mn[:, 0] * mj[:, 1]
        det = torch.where(det.abs() < 1e-12, 1e-12, det)[:, None, None]
        u = (fx * mn[:, 1, None, None] - mn[:, 0, None, None] * fy) / det
        v = (mj[:, 0, None, None] * fy - fx * mj[:, 1, None, None]) / det
        inside = ((u.abs() <= 1) & (v.abs() <= 1)
                  & proj.valid[sl, None, None])
        z = torch.where(inside, radial[sl, None, None], float("inf"))
        depth = torch.minimum(depth, z.amin(dim=0))
    return torch.where(torch.isinf(depth), 1.0, depth)


@torch.no_grad()
def render_shadow_cubemap(
    splats: Splats,
    light_pos,
    far,
    std_dev,
    size: int = 1024,
    chunk: int = 256,
    method: str = "auto",
    pair_capacity: int = 0,
    model_to_world=None,
    splat_format: SplatFormat = SplatFormat.MESH2SPLAT,
    device="cuda",
) -> ShadowCubemap:
    """All six faces of the light's cubemap on ``device`` (the splats move
    there). method: "tiled" (one band-clamped binning and K5 for all
    faces; ``size`` a multiple of the tile height), "dense" (every (splat,
    pixel), O(N size^2)) or "auto" (tiled for size >= 512 or more than
    65,536 splats). pair_capacity: the class-C budget, 0 to size it to
    this scene."""
    with annotate("m2s.render.shadow"):
        dev = resolve_device(device)
        splats = to_device(splats, dev)
        light_pos = torch.as_tensor(light_pos, dtype=torch.float32, device=dev)
        far = torch.as_tensor(far, dtype=torch.float32, device=dev)
        if model_to_world is not None:
            model_to_world = model_to_world.to(dev)

        if method == "auto":
            method = ("tiled" if size >= 512 or splats.capacity > 65536
                      else "dense")
        if method == "tiled":
            if size % B.TILE_H:
                # the band scissor takes each face as whole tile rows
                raise ValueError(
                    f"tiled shadow size must be a multiple of {B.TILE_H}")
            merged, band, need = _shadow_prep_fused(
                splats, light_pos, far, std_dev, size, model_to_world,
                splat_format)
            cap = pair_capacity or B.round_pow2_budget(need)
            faces = _fused_min_raster(merged, band, size, cap)
        elif method == "dense":
            radial, projs = _shadow_prep(splats, light_pos, far, std_dev, size,
                                         model_to_world, splat_format)
            faces = torch.stack([_min_rasterize_face(p, radial, size, chunk)
                                 for p in projs])
        else:
            raise ValueError(f"method {method!r}: 'auto', 'tiled' or 'dense'")
        return ShadowCubemap(faces=faces, light_pos=light_pos, far=far)


def sample_cubemap(faces, directions, filter_linear: bool = False):
    """Sample a (6, S, S) cubemap by direction (..., 3) with GL face and uv
    conventions: nearest with edge clamp by default (the shadow sampler),
    bilinear within a face with ``filter_linear``."""
    s = faces.shape[1]
    x, y, z = directions[..., 0], directions[..., 1], directions[..., 2]
    face = dominant_face(directions)
    ma = torch.maximum(torch.maximum(x.abs(), y.abs()), z.abs())
    ma = torch.clamp(ma, min=1e-12)
    f = face.long()
    sc = torch.stack([-z, z, x, x, x, -x], -1).gather(-1, f[..., None])[..., 0]
    tc = torch.stack([-y, -y, z, -z, -y, -y], -1).gather(-1, f[..., None])[
        ..., 0]
    u = (sc / ma + 1.0) * 0.5
    v = (tc / ma + 1.0) * 0.5
    if not filter_linear:
        ui = torch.clamp((u * s).to(torch.int32), 0, s - 1).long()
        vi = torch.clamp((v * s).to(torch.int32), 0, s - 1).long()
        return faces[f, vi, ui]

    uf = u * s - 0.5
    vf = v * s - 0.5
    u0 = torch.floor(uf)
    v0 = torch.floor(vf)
    fu = uf - u0
    fv = vf - v0
    u0i = torch.clamp(u0.to(torch.int32), 0, s - 1).long()
    v0i = torch.clamp(v0.to(torch.int32), 0, s - 1).long()
    u1i = torch.clamp(u0i + 1, 0, s - 1)
    v1i = torch.clamp(v0i + 1, 0, s - 1)
    t00 = faces[f, v0i, u0i]
    t01 = faces[f, v0i, u1i]
    t10 = faces[f, v1i, u0i]
    t11 = faces[f, v1i, u1i]
    return (t00 * (1 - fu) * (1 - fv) + t01 * fu * (1 - fv)
            + t10 * (1 - fu) * fv + t11 * fu * fv)


def pcf_shadow_factor(cubemap: ShadowCubemap, ws_pos, bias: float = 0.05,
                      disk_radius: float = 0.025):
    """20-tap PCF: the share of taps whose stored distance lies nearer the
    light than ``ws_pos`` (..., 3) by more than ``bias``; in [0, 1]."""
    light_dir = ws_pos - cubemap.light_pos
    current = _norm3(light_dir)
    sample_dir = light_dir / (current[..., None] + 1e-12)
    offsets = torch.from_numpy(_PCF_OFFSETS).to(ws_pos.device) * disk_radius
    dirs = sample_dir[..., None, :] + offsets                # (..., 20, 3)
    closest = sample_cubemap(cubemap.faces, dirs) * cubemap.far
    hit = (current[..., None] - bias > closest).to(torch.float32)
    return hit.mean(dim=-1)
