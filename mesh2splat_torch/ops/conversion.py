"""Mesh -> Gaussian-splat conversion (counterpart of
``mesh2splat_tpu.ops.conversion``).

  1. Per-triangle math: orthogonal UVs, tangent-frame quaternion, UV->3D
     Jacobian scale, and the triangle's texel-space bounding box.
  2. Scanline row expansion: each triangle claims one producer per covered
     texel row (exclusive cumsum), each row the exact covered column range.
  3. Row -> texel-slot expansion by scatter-max + cummax forward fills: the
     replacement for the reference's atomic appends.
  4. The fragment shader (ops.fragment): K1 texel rows, then K2's fragment
     math, which reads each slot's taps from the atlas at K1's row (no
     gathered copy of the taps is made). Each slot's index within its
     texel row (``local``) comes from the kernels: K1 computes it where it
     runs, else K2 does; only a mesh too large for the packed slot key
     fills it in stage 3.

``convert`` is differentiable with respect to the material (textures and
factors) and the mesh attributes: the f32 tap atlas and the fragment VJP
(which gathers the taps again) carry the gradient; the slot allocation is
integer.

Slot order equals the JAX package's, so splats compare element by element.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..types import Material, Splats, TriangleMesh
from ..utils.profiling import annotate
from . import fragment, segments
from .numerics import div, fma, sqrt
from .triplanar import triangle_conversion_attrs


def _fit(tex, has, c, fill, h, w, device):
    """A material layer at (h, w): the texture, bilinearly resized when its
    size differs, or a constant fill where the material has none."""
    if not has:
        return torch.tensor(fill, dtype=torch.float32,
                            device=device).expand(h, w, c)
    if tuple(tex.shape[:2]) != (h, w):
        tex = F.interpolate(tex.permute(2, 0, 1)[None], size=(h, w),
                            mode="bilinear", align_corners=False,
                            antialias=True)[0].permute(1, 2, 0)
    return tex


_NORMAL_FILL = [0.5, 0.5, 1.0]
_MR_FILL = [0.0, 0.5, 0.1]  # .g = roughness 0.5, .b = metallic 0.1


def _material_layer(mat: Material, h, w):
    dev = mat.base_color.device
    return torch.cat([
        _fit(mat.base_color, mat.has_base_color, 4, [1.0] * 4, h, w, dev),
        _fit(mat.normal, mat.has_normal, 3, _NORMAL_FILL, h, w, dev),
        _fit(mat.metallic_roughness, mat.has_metallic_roughness, 3,
             _MR_FILL, h, w, dev),
    ], dim=-1)


def _material_stack(material: Material):
    """One (1, H, W, 10) layer: base rgba | normal xyz | metallic-roughness
    rgb, or None when the material has no texture at all."""
    sizes = [tuple(t.shape[:2]) for t, has in (
        (material.base_color, material.has_base_color),
        (material.normal, material.has_normal),
        (material.metallic_roughness, material.has_metallic_roughness),
    ) if has]
    if not sizes:
        return None
    h = max(s[0] for s in sizes)
    w = max(s[1] for s in sizes)
    return _material_layer(material, h, w)[None]


@dataclasses.dataclass(frozen=True)
class PackedAtlas:
    """Prebuilt bilinear tap atlas for a material (build_pair_atlas output +
    its geometry), built once and reused across conversions."""

    atlasT: torch.Tensor   # (k*4*10, n_rows) f32 or (k*4*10/2, n_rows) int32
    geom: tuple = ((0, 1, 1, 1),)
    k: int = 1
    packed: bool = False


def pack_atlas(material: Material, precision: str = "bf16",
               mips: bool = True) -> PackedAtlas | None:
    """Build a material's PackedAtlas once (None for textureless materials).
    precision "bf16" packs channel pairs as two bf16s per int32 lane; "f32"
    keeps full precision."""
    if precision not in ("bf16", "f32"):
        raise ValueError(f"precision={precision!r}: must be 'bf16' or 'f32'")
    stack = _material_stack(material)
    if stack is None:
        return None
    m, th, tw_tex, _ = stack.shape
    k = fragment.pack_factor(m * th * tw_tex)
    atlasT, geom = fragment.build_pair_atlas(
        stack, k, packed=precision == "bf16", mips=mips
    )
    return PackedAtlas(atlasT=atlasT, geom=tuple(geom), k=k,
                       packed=precision == "bf16")


@dataclasses.dataclass(frozen=True)
class ConversionConfig:
    """Conversion parameters.

    resolution: the texel grid (16..4096). layers: average coverage budget
    per texel; capacity = res^2 * layers. capacity_override /
    row_capacity_override: exact slot / row budgets (see calibrate).
    use_mips: nearest-mip texture sampling from a per-triangle LOD.
    """

    resolution: int = 256
    layers: int = 6
    max_texels_per_tri: int = 0
    gaussian_std: float = 1.0
    capacity_override: int = 0
    row_capacity_override: int = 0
    use_mips: bool = True

    @property
    def capacity(self) -> int:
        if self.capacity_override:
            return self.capacity_override
        return self.resolution * self.resolution * self.layers

    @property
    def row_capacity(self) -> int:
        return self.row_capacity_override or self.capacity

    @property
    def scale_multiplier(self) -> float:
        """sigma applied at export/render time: gaussian_std / resolution."""
        return self.gaussian_std / self.resolution


def _triangle_texel_bbox(ouv, res):
    """Integer texel bbox (x0, y0, w, h) of the UV triangle's covered
    texel centers."""
    lo = ouv.amin(dim=1)
    hi = ouv.amax(dim=1)
    x0 = torch.ceil(fma(lo, res, -0.5)).to(torch.int32)
    x1 = torch.floor(fma(hi, res, -0.5)).to(torch.int32)
    x0 = torch.clamp(x0, 0, res - 1)
    x1 = torch.clamp(x1, -1, res - 1)
    wh = torch.clamp(x1 - x0 + 1, min=0)
    return x0[:, 0], x0[:, 1], wh[:, 0], wh[:, 1]


def _row_span(ouv6, tx0, tw, y, res):
    """Exact covered column range (c0, c1, nonempty) of a texel row at center
    ordinate y. Must stay operation-for-operation identical to
    fragment._row_span_cols."""

    def edge_x(pu, pv, qu, qv):
        den = qv - pv
        span = ((pv - y) * (qv - y) <= 0) & (den.abs() > 1e-20)
        tt_ = (y - pv) / torch.where(span, den, 1.0)
        xx = fma(tt_, qu - pu, pu)
        return torch.where(span, xx, 3e38), torch.where(span, xx, -3e38)

    lo0, hi0 = edge_x(ouv6[:, 0], ouv6[:, 1], ouv6[:, 2], ouv6[:, 3])
    lo1, hi1 = edge_x(ouv6[:, 2], ouv6[:, 3], ouv6[:, 4], ouv6[:, 5])
    lo2, hi2 = edge_x(ouv6[:, 4], ouv6[:, 5], ouv6[:, 0], ouv6[:, 1])
    xlo = torch.minimum(torch.minimum(lo0, lo1), lo2)
    xhi = torch.maximum(torch.maximum(hi0, hi1), hi2)

    c0 = fragment._to_index(torch.ceil(fma(xlo, res, -0.5) - 1e-2))
    c1 = fragment._to_index(torch.floor(fma(xhi, res, -0.5) + 1e-2))
    c0 = torch.minimum(torch.maximum(c0, tx0), tx0 + tw - 1)
    c1 = torch.minimum(torch.maximum(c1, tx0), tx0 + tw - 1)
    return c0, c1, xlo <= xhi


def _attrs(mesh, bbox_min, bbox_max, ortho_uv=None):
    if bbox_min.ndim == 2:
        bbox_min, bbox_max = bbox_min[:, None, :], bbox_max[:, None, :]
    return triangle_conversion_attrs(mesh.tri_pos, bbox_min, bbox_max,
                                     ouv_override=ortho_uv)


def _row_counts(mesh, ouv, res):
    """Per-triangle texel bbox and the number of texel rows it claims
    (0 for non-finite triangles)."""
    x0, y0, w, h = _triangle_texel_bbox(ouv, res)
    t = mesh.tri_pos.shape[0]
    finite = torch.isfinite(mesh.tri_pos.reshape(t, -1)).all(dim=-1)
    n_rows = torch.where(finite & (w > 0), h, 0)
    return x0, y0, w, n_rows


def _row_widths(mesh, ouv, res, row_cap, max_texels_per_tri):
    """Stage 2: scanline rows -> (geo, row_tri, row_local, width, demand)."""
    t = mesh.tri_pos.shape[0]
    dev = ouv.device
    x0, y0, w, n_rows = _row_counts(mesh, ouv, res)
    row_off, row_total = segments.alloc_slots(n_rows, row_cap)
    row_local, _, row_tri = segments.expand_monotone(
        row_off, n_rows, row_cap,
        value=torch.arange(t, dtype=torch.int32, device=dev),
    )
    row_live = torch.arange(row_cap, dtype=torch.int32, device=dev) < row_total
    row_tri = torch.clamp(row_tri, min=0)

    geo = torch.cat([
        ouv.reshape(t, 6), x0[:, None].float(), y0[:, None].float(),
        w[:, None].float(),
    ], dim=-1)  # (T, 9)
    g = geo[row_tri.long()]
    tx0 = g[:, 6].to(torch.int32)
    tw = g[:, 8].to(torch.int32)
    j = g[:, 7].to(torch.int32) + row_local
    y = div(j.to(torch.float32) + 0.5, res)
    c0, c1, nonempty = _row_span(g[:, 0:6], tx0, tw, y, res)
    width = torch.where(row_live & nonempty, c1 - c0 + 1, 0)
    width = torch.clamp(width, min=0)
    if max_texels_per_tri:
        width = torch.clamp(width, max=max_texels_per_tri)
    return geo, row_tri, row_local, width, n_rows.sum()


# Each slot's (tri, row_local) travels through one cummax as the packed key
# tri * 4096 + row_local (texel rows per triangle never exceed res <= 4096)
# while t * 4096 stays below this; a larger mesh takes expand_to_slots'
# generic fill, which also gives each slot's local.
PACKED_KEY_LIMIT = 2**31


def _expand_slots(mesh, bbox_min, bbox_max, config, ortho_uv=None):
    """Stages 1-3: per-triangle attributes, scanline row expansion and
    row -> texel-slot expansion. ``local`` is None where the mesh packs:
    the kernels compute it from the slots' (tri, row_local) keys."""
    with annotate("m2s.convert.slots"):
        res = config.resolution
        cap = config.capacity
        attrs = _attrs(mesh, bbox_min, bbox_max, ortho_uv)
        ouv = attrs["ortho_uv"]
        t = mesh.tri_pos.shape[0]
        geo, row_tri, row_local, width, row_demand = _row_widths(
            mesh, ouv, res, config.row_capacity, config.max_texels_per_tri)

        offsets, total = segments.alloc_slots(width, cap)
        local = None
        if t * 4096 < PACKED_KEY_LIMIT:
            # one monotone packed channel (tri * 4096 + row_local) through
            # cummax
            packed = segments.fill_value(offsets, width, cap,
                                         row_tri * 4096 + row_local)
            packed = torch.clamp(packed, min=0)
            tri_id_safe = packed >> 12
            s_row_local = packed & 4095
        else:
            _, local, _, ex = segments.expand_to_slots(
                offsets, width, cap, extra=torch.stack([row_tri, row_local])
            )
            tri_id_safe = torch.clamp(ex[0], min=0)
            s_row_local = torch.clamp(ex[1], min=0)
        in_budget = torch.arange(cap, dtype=torch.int32,
                                 device=ouv.device) < total
        return dict(
            attrs=attrs, ouv=ouv, geo=geo, tri_id_safe=tri_id_safe,
            s_row_local=s_row_local, local=local, in_budget=in_budget,
            total=total, t=t, row_demand=row_demand, slot_demand=width.sum(),
        )


def _overflow_stats(ex, config: ConversionConfig) -> dict:
    """Budget-overflow counters: dropped_rows (row producers past
    row_capacity), dropped_slots (texel slots past capacity) and
    dropped_window, always 0 here (the port has no record-window path)."""
    zero = torch.zeros((), dtype=torch.int64, device=ex["ouv"].device)
    return {
        "dropped_rows": torch.clamp(ex["row_demand"] - config.row_capacity,
                                    min=0),
        "dropped_slots": torch.clamp(ex["slot_demand"] - config.capacity,
                                     min=0),
        "dropped_window": zero,
    }


def _triangle_lod(mesh, ouv, res, n_levels, th0, tw0):
    """Per-triangle nearest mip level from the ortho-UV -> texture-UV
    footprint (constant per triangle)."""
    t = mesh.tri_pos.shape[0]
    if n_levels <= 1:
        return torch.zeros((t,), dtype=torch.float32, device=ouv.device)
    uvt = mesh.tri_uv
    d1 = ouv[:, 1] - ouv[:, 0]
    d2 = ouv[:, 2] - ouv[:, 0]
    e1 = uvt[:, 1] - uvt[:, 0]
    e2 = uvt[:, 2] - uvt[:, 0]
    det = fma(d1[:, 0], d2[:, 1], -(d2[:, 0] * d1[:, 1]))
    small = det.abs() < 1e-20
    safe = torch.where(small, 1.0, det)
    a00 = fma(e1[:, 0], d2[:, 1], -(e2[:, 0] * d1[:, 1])) / safe
    a01 = fma(-e1[:, 0], d2[:, 0], e2[:, 0] * d1[:, 0]) / safe
    a10 = fma(e1[:, 1], d2[:, 1], -(e2[:, 1] * d1[:, 1])) / safe
    a11 = fma(-e1[:, 1], d2[:, 0], e2[:, 1] * d1[:, 0]) / safe
    sx_t, sy_t = tw0 / res, th0 / res

    def sumsq(p, q):
        p, q = p * sx_t, q * sy_t
        return fma(p, p, q * q)

    rho = sqrt(torch.maximum(sumsq(a00, a10), sumsq(a01, a11)))
    lod = torch.clamp(torch.round(torch.log2(torch.clamp(rho, min=1.0))),
                      0, n_levels - 1)
    return torch.where(small, 0.0, lod)


def _finish_convert(mesh, config, stack, mids, factors, has_base,
                    has_normal, has_mr, ex, atlas: PackedAtlas | None = None):
    """Stage 4: record table, K1, K2 (reading the tap atlas by K1's rows)
    -> Splats."""
    with annotate("m2s.convert.fragment"):
        res = config.resolution
        cap = config.capacity
        t = ex["t"]
        ouv, geo, attrs = ex["ouv"], ex["geo"], ex["attrs"]
        dev = ouv.device
        if t >= 1 << 24:
            raise ValueError(
                f"{t} triangles exceeds the f32 triangle-id range of the "
                "fragment kernels (2^24); split the scene into several "
                "converts"
            )
        if mids is None:
            mids = torch.zeros((t,), dtype=torch.int32, device=dev)
        fac_t = factors[mids.long()]

        if atlas is not None:
            n_levels = len(atlas.geom)
            th0, tw0 = atlas.geom[0][1], atlas.geom[0][2]
            if n_levels != len(fragment.mip_dims(th0, tw0, config.use_mips)):
                raise ValueError(
                    f"config.use_mips={config.use_mips} conflicts with the "
                    f"prebuilt atlas ({n_levels} level(s)); rebuild with "
                    f"pack_atlas(material, mips={config.use_mips})"
                )
        elif stack is not None:
            th0, tw0 = stack.shape[1], stack.shape[2]
            n_levels = len(fragment.mip_dims(th0, tw0, config.use_mips))
        else:
            n_levels, th0, tw0 = 1, 1, 1
        lod_t = _triangle_lod(mesh, ouv, res, n_levels, th0, tw0)

        record = torch.cat([
            ouv.reshape(t, 6),                        # au..cv       (0-5)
            geo[:, 6:9],                              # tx0 ty0 tw   (6-8)
            mesh.tri_uv.reshape(t, 6),                # ua..vc       (9-14)
            mids[:, None].float(),                    # mid          (15)
            lod_t[:, None],                           # lod          (16)
            mesh.tri_pos.reshape(t, 9),               # (17-25)
            mesh.tri_normal.reshape(t, 9),            # (26-34)
            mesh.tri_tangent.reshape(t, 12),          # (35-46)
            attrs["quat"],                            # (47-50)
            attrs["scale"],                           # (51-53)
            fac_t,                                    # (54-57)
            torch.zeros((t, fragment.REC_W - 58), device=dev),
        ], dim=-1)
        # non-finite fields belong to degenerate triangles, which own no slots
        record = torch.where(torch.isfinite(record), record, 0.0)
        t_pad = -(-(t + 128) // 128) * 128
        # (REC_W, T_pad)
        records = F.pad(record.T, (0, t_pad - t)).contiguous()
        local = ex["local"]
        metaT = torch.stack([
            ex["tri_id_safe"], ex["s_row_local"],
            torch.zeros_like(ex["s_row_local"]) if local is None else local,
            ex["in_budget"].to(torch.int32),
        ]).float().contiguous()  # (4, cap) [tri, row_local, local, live]

        taps_packed = False
        if atlas is not None:
            atlasT, geom, k = atlas.atlasT, atlas.geom, atlas.k
            taps_packed = atlas.packed
        elif stack is not None:
            m, th, tw_tex, _ = stack.shape
            k = fragment.pack_factor(m * th * tw_tex)
            atlasT, geom = fragment.build_pair_atlas(stack, k,
                                                     mips=config.use_mips)
        if atlas is not None or stack is not None:
            # K1 also writes each slot's local into metaT's row 2, for K2; K2
            # reads each slot's taps from the atlas at its row
            rows_idx = fragment.texel_rows(
                records, metaT, res=res, geom=geom, k=k,
                n_rows=atlasT.shape[1],
            )
            tapsT = atlasT
            local_in_kernel = False
        else:
            geom, k = ((0, 1, 1, 1),), 1
            tapsT, rows_idx = torch.zeros((1, 1), device=dev), None  # not read
            # no K1: K2 computes local, unless stage 3 filled it
            local_in_kernel = local is None

        outT, _ = fragment.fragment_apply(
            records, tapsT, metaT, res, tuple(geom), k,
            has_base, has_normal, has_mr, taps_packed,
            local_in_kernel=local_in_kernel, rows=rows_idx,
        )
        return Splats(
            pos=outT[0:3].T, color=outT[3:7].T, scale=outT[7:10].T,
            normal=outT[10:13].T, quat=outT[13:17].T, pbr=outT[17:19].T,
            valid=outT[19] > 0.0,
        )


def _convert_core(mesh, bbox_min, bbox_max, config, stack, mids, factors,
                  has_base, has_normal, has_mr, ortho_uv=None,
                  return_stats=False, atlas=None):
    ex = _expand_slots(mesh, bbox_min, bbox_max, config, ortho_uv)
    splats = _finish_convert(mesh, config, stack, mids, factors, has_base,
                             has_normal, has_mr, ex, atlas)
    if not return_stats:
        return splats
    return splats, _overflow_stats(ex, config)


def convert(mesh: TriangleMesh, material: Material, bbox_min, bbox_max,
            config: ConversionConfig, ortho_uv=None, return_stats=False,
            atlas: PackedAtlas | None = None):
    """Convert one primitive (triangle soup + material) to splats on the
    mesh tensors' device. bbox_min/max: the per-mesh bbox used for ortho-UV
    normalization. atlas: optional pack_atlas(material) result (a packed
    atlas is a constant: no gradient reaches the textures through it)."""
    return _convert_core(
        mesh, bbox_min, bbox_max, config,
        stack=None if atlas is not None else _material_stack(material),
        mids=None, factors=material.base_color_factor[None],
        has_base=material.has_base_color, has_normal=material.has_normal,
        has_mr=material.has_metallic_roughness, ortho_uv=ortho_uv,
        return_stats=return_stats, atlas=atlas,
    )


@torch.no_grad()
def required_rows(mesh, bbox_min, bbox_max, config) -> torch.Tensor:
    """Number of (triangle, texel-row) producers the scanline allocator
    needs for this mesh."""
    ouv = _attrs(mesh, bbox_min, bbox_max)["ortho_uv"]
    return _row_counts(mesh, ouv, config.resolution)[3].sum()


@torch.no_grad()
def required_slots(mesh, bbox_min, bbox_max, config) -> torch.Tensor:
    """Exact texel-slot requirement: the sum of scanline row widths (uses
    config.row_capacity for the row expansion, so calibrate rows first)."""
    ouv = _attrs(mesh, bbox_min, bbox_max)["ortho_uv"]
    _, _, _, width, _ = _row_widths(mesh, ouv, config.resolution,
                                    config.row_capacity,
                                    config.max_texels_per_tri)
    return width.sum()


def calibrate(mesh, bbox_min, bbox_max, config: ConversionConfig,
              round_to: int = 8192, n_primitives: int = 1) -> ConversionConfig:
    """A config whose row and texel budgets exactly fit this mesh (rounded
    up, capped at res^2 * layers * n_primitives); same splats, lower cost."""
    with annotate("m2s.convert.calibrate"):
        hard_cap = (config.resolution * config.resolution * config.layers
                    * max(n_primitives, 1))

        def round_up(n):
            return min(-(-max(int(n), 1) // round_to) * round_to, hard_cap)

        rows = round_up(required_rows(mesh, bbox_min, bbox_max, config))
        cfg_rows = dataclasses.replace(config, row_capacity_override=rows)
        cap = round_up(required_slots(mesh, bbox_min, bbox_max, cfg_rows))
        return dataclasses.replace(cfg_rows,
                                   capacity_override=max(cap, round_to))


def _merge(primitives, shared_bbox):
    meshes = [m for m, _ in primitives]
    counts = [int(m.tri_pos.shape[0]) for m in meshes]
    dev = meshes[0].tri_pos.device
    merged = TriangleMesh(
        tri_pos=torch.cat([m.tri_pos for m in meshes]),
        tri_normal=torch.cat([m.tri_normal for m in meshes]),
        tri_tangent=torch.cat([m.tri_tangent for m in meshes]),
        tri_uv=torch.cat([m.tri_uv for m in meshes]),
    )
    if shared_bbox is not None:
        lo, hi = shared_bbox
        bb_lo = torch.as_tensor(lo, dtype=torch.float32, device=dev)
        bb_hi = torch.as_tensor(hi, dtype=torch.float32, device=dev)
    else:
        parts_lo, parts_hi = [], []
        for m, c in zip(meshes, counts):
            lo, hi = m.bbox()
            parts_lo.append(lo.expand(c, 3))
            parts_hi.append(hi.expand(c, 3))
        bb_lo = torch.cat(parts_lo)
        bb_hi = torch.cat(parts_hi)
    mids = torch.from_numpy(
        np.repeat(np.arange(len(meshes), dtype=np.int32), counts)).to(dev)
    return merged, bb_lo, bb_hi, mids


@torch.no_grad()
def convert_packed(primitives, config: ConversionConfig, shared_bbox=None,
                   calibrate_budget: bool = False, return_stats: bool = False):
    """Convert a whole multi-primitive scene in one pass: one merged
    triangle soup with a per-triangle material id and bbox, and one layered
    tap atlas. Materials lacking a map where another has one get a neutral
    layer (see mesh2splat_tpu.ops.conversion.convert_packed)."""
    mats = [mt for _, mt in primitives]
    merged, bb_lo, bb_hi, mids = _merge(primitives, shared_bbox)
    any_base = any(mt.has_base_color for mt in mats)
    any_normal = any(mt.has_normal for mt in mats)
    any_mr = any(mt.has_metallic_roughness for mt in mats)
    factors = torch.stack([mt.base_color_factor for mt in mats])  # (M, 4)

    stack = None
    if any_base or any_normal or any_mr:
        sizes = []
        for mt in mats:
            for tex, has in ((mt.base_color, mt.has_base_color),
                             (mt.normal, mt.has_normal),
                             (mt.metallic_roughness,
                              mt.has_metallic_roughness)):
                if has:
                    sizes.append(tuple(tex.shape[:2]))
        h = max(s[0] for s in sizes)
        w = max(s[1] for s in sizes)
        stack = torch.stack([_material_layer(mt, h, w) for mt in mats])

    if calibrate_budget:
        config = calibrate(merged, bb_lo, bb_hi, config,
                           n_primitives=len(primitives))
    elif not config.capacity_override and len(primitives) > 1:
        config = dataclasses.replace(
            config,
            capacity_override=min(
                config.resolution ** 2 * config.layers * len(primitives),
                7_000_000,
            ),
        )
    return _convert_core(
        merged, bb_lo, bb_hi, config, stack=stack, mids=mids,
        factors=factors, has_base=any_base, has_normal=any_normal,
        has_mr=any_mr, return_stats=return_stats,
    )
