"""Per-slot "fragment shader" of conversion (counterpart of
``mesh2splat_tpu.ops.fragment``): kernel K1 (``texel_rows``, the bilinear
footprint's packed atlas row per slot) and kernel K2 (``fragment_apply``,
coverage, barycentric lerps, bilinear mix and TBN normal mapping), around
the tap atlas, which K2 reads by K1's rows.

Every per-slot quantity is field-major: a (F, N) tensor whose row f is one
field over all N slots. A CUDA tensor launches the hand-written kernels of
``mesh2splat_torch.kernels``; a CPU tensor takes the plain versions below
(``texel_rows_plain``, ``fragment_apply_plain``), which do the kernels'
arithmetic in the same order. Where a float decides an integer (texel
column, coverage, tap index), both fuse a multiply-add exactly where the
reference's arithmetic does (``numerics.fma`` here, ``fmaf`` in the kernels,
which otherwise build without FMA contraction), so the two agree bit for bit
with each other and with the reference.

``fragment_apply`` is differentiable with respect to the records (the mesh
attributes) and f32 taps or the f32 atlas they come from (the textures):
its backward gathers the records and taps again and recomputes the plain
math under autograd, as the JAX package's VJP differentiates
``_fragment_math`` in XLA. Packed (bf16-pair) taps get no gradient.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..utils.profiling import annotate
from .numerics import div, fma, sqrt

# ---- record layout: field-major rows of the (REC_W, T_pad) record table ---
REC = {
    "au": 0, "av": 1, "bu": 2, "bv": 3, "cu": 4, "cv": 5,      # ortho-UV
    "tx0": 6, "ty0": 7, "tw": 8,                                # texel bbox
    "ua": 9, "va": 10, "ub": 11, "vb": 12, "uc": 13, "vc": 14,  # texture UV
    "mid": 15,                                                  # material id
    "lod": 16,                                                  # mip level
    "pax": 17, "pay": 18, "paz": 19, "pbx": 20, "pby": 21, "pbz": 22,
    "pcx": 23, "pcy": 24, "pcz": 25,                            # tri_pos
    "nax": 26, "nay": 27, "naz": 28, "nbx": 29, "nby": 30, "nbz": 31,
    "ncx": 32, "ncy": 33, "ncz": 34,                            # tri_normal
    "tax": 35, "tay": 36, "taz": 37, "taw": 38,
    "tbx": 39, "tby": 40, "tbz": 41, "tbw": 42,
    "tcx": 43, "tcy": 44, "tcz": 45, "tcw": 46,                 # tri_tangent
    "qw": 47, "qx": 48, "qy": 49, "qz": 50,                     # quat
    "sx": 51, "sy": 52, "sz": 53,                               # scale
    "fr": 54, "fg": 55, "fb": 56, "fa": 57,                     # color factor
}
REC_W = 64          # record rows (the JAX package's layout)
GEO_W = 24          # rows K1 reads (0..23)
TAPS_C = 10         # channels per tap: rgba | normal xyz | mr rgb
MAX_PACK = 4        # max texels packed per atlas row
FAST_ROWS = 196608  # the JAX package's gather-tier bound; kept so atlases match

# fragment outputs, field-major: rows 0-2 pos | 3-6 color | 7-9 scale |
# 10-12 normal | 13-16 quat | 17-18 pbr | 19 valid
OUT_W = 20


def pack_factor(total_texels: int) -> int:
    """Texels per atlas row (<= MAX_PACK), as the JAX package packs them."""
    k = 1
    while k < MAX_PACK and -(-total_texels // k) > FAST_ROWS:
        k *= 2
    return k


def mip_dims(h: int, w: int, mips: bool, max_levels: int = 8):
    """Mip-chain dimensions [(h, w), ...]: exact 2x box halving while both
    sides stay even and >= 8."""
    dims = [(h, w)]
    while (mips and len(dims) < max_levels
           and h % 2 == 0 and w % 2 == 0 and h >= 16 and w >= 16):
        h, w = h // 2, w // 2
        dims.append((h, w))
    return dims


def mip_geometry(h: int, w: int, k: int, mips: bool, n_layers: int = 1):
    """Per-level atlas geometry ((row_off, h, w, hw_pad), ...)."""
    geom = []
    off = 0
    for lh, lw in mip_dims(h, w, mips):
        hw_pad = -(-(lh * lw) // k) * k
        geom.append((off, lh, lw, hw_pad))
        off += n_layers * hw_pad // k
    return tuple(geom)


def downsample2(stack):
    """Exact 2x2 box filter per layer/channel; the four taps are summed in
    row-major order, as XLA reduces them."""
    m, h, w, c = stack.shape
    r = stack.reshape(m, h // 2, 2, w // 2, 2, c)
    s = r[:, :, 0, :, 0] + r[:, :, 0, :, 1] + r[:, :, 1, :, 0] + r[:, :, 1, :, 1]
    return s / 4.0


def build_pair_atlas(stack: torch.Tensor, k: int, packed: bool = False,
                     mips: bool = False):
    """(M, H, W, C) texture stack -> transposed tap atlas (4*C*k, n_rows) +
    per-level geometry. Each row holds the 2x2 bilinear footprints of k
    texels (REPEAT wrap within the layer). packed=True stores channel pairs
    as two bf16s per int32 lane (field f high, field f + n/2 low), rounded
    to nearest even. The atlas is the transpose of a contiguous
    (n_rows, 4*C*k) tensor: one atlas row's fields lie together, where K2
    reads a slot's taps as 16-byte vectors."""
    m, h, w, c = stack.shape
    geom = mip_geometry(h, w, k, mips, n_layers=m)

    def level_rows(lvl, hw_pad):
        lm, lh, lw, lc = lvl.shape
        t01 = torch.roll(lvl, -1, dims=2)
        t10 = torch.roll(lvl, -1, dims=1)
        t11 = torch.roll(t10, -1, dims=2)
        taps = torch.cat([lvl, t01, t10, t11], dim=-1)
        hw = lh * lw
        flat = taps.reshape(lm, hw, 4 * lc)
        if hw_pad != hw:
            flat = torch.nn.functional.pad(flat, (0, 0, 0, hw_pad - hw))
        return flat.reshape(lm * hw_pad // k, k * 4 * lc)

    rows = []
    cur = stack
    for _, lh, _, hw_pad in geom:
        if cur.shape[1] != lh:
            cur = downsample2(cur)
        rows.append(level_rows(cur, hw_pad))
    atlas = torch.cat(rows, dim=0)  # (n_rows, k*4*c)
    if not packed:
        return atlas.T, geom
    half = atlas.shape[1] // 2

    def bf16_bits(x):
        return x.to(torch.bfloat16).to(torch.float32).view(torch.int32)

    hi = bf16_bits(atlas[:, :half]) & -65536               # 0xFFFF0000
    lo = (bf16_bits(atlas[:, half:]) >> 16) & 0xFFFF       # logical shift
    return (hi | lo).contiguous().T, geom


def _unpack_taps(packed_i32):
    """(n/2, N) int32 bf16 pairs -> (n, N) f32."""
    hi = (packed_i32 & -65536).view(torch.float32)
    lo = (packed_i32 << 16).view(torch.float32)
    return torch.cat([hi, lo], dim=0)


def _to_index(x):
    """float -> int32 for texel and tap indices: NaN -> 0 and a clamp into
    [-2^30, 2^30] first, so that +-inf (a row no edge spans) converts the
    same way on the CPU, in the CUDA kernels and in XLA (which saturates);
    finite in-range values convert as a plain cast does."""
    return torch.nan_to_num(x, nan=0.0).clamp(-2.0**30, 2.0**30).to(torch.int32)


def _row_span_cols(au, av, bu, bv, cu, cv, tx0, tw, y, res):
    """First covered texel column of the row at center ordinate y. MUST stay
    operation-for-operation identical to conversion._row_span (fused
    multiply-adds where the reference's arithmetic fuses them)."""

    def edge_x(pu_, pv_, qu_, qv_):
        den = qv_ - pv_
        span = ((pv_ - y) * (qv_ - y) <= 0) & (den.abs() > 1e-20)
        tt_ = (y - pv_) / torch.where(span, den, 1.0)
        xx = fma(tt_, qu_ - pu_, pu_)
        return torch.where(span, xx, 3e38)

    xlo = torch.minimum(torch.minimum(edge_x(au, av, bu, bv),
                                      edge_x(bu, bv, cu, cv)),
                        edge_x(cu, cv, au, av))
    c0 = _to_index(torch.ceil(fma(xlo, res, -0.5) - 1e-2))
    return torch.minimum(torch.maximum(c0, tx0), tx0 + tw - 1)


def _slot_uv(rec, meta, res):
    """Per-slot texel center, barycentrics, coverage and texture uv: the
    shared front half of K1 and K2. rec: (>= GEO_W, N) records per slot;
    meta: (4, N) f32 [tri, row_local, local, live]."""
    f = lambda name: rec[REC[name]]  # noqa: E731
    row_local = meta[1]
    local = meta[2]
    live = meta[3] > 0.0

    tx0 = f("tx0").to(torch.int32)
    tw = f("tw").to(torch.int32)
    tj = f("ty0").to(torch.int32) + row_local.to(torch.int32)
    y_s = div(tj.to(torch.float32) + 0.5, res)

    au, av, bu, bv, cu, cv = (f(n) for n in ("au", "av", "bu", "bv", "cu", "cv"))
    sc0 = _row_span_cols(au, av, bu, bv, cu, cv, tx0, tw, y_s, res)
    ti = sc0 + local.to(torch.int32)
    pu = div(ti.to(torch.float32) + 0.5, res)
    pv = y_s

    v0u, v0v = bu - au, bv - av
    v1u, v1v = cu - au, cv - av
    v2u, v2v = pu - au, pv - av
    den = fma(v0u, v1v, -(v1u * v0v))
    safe = torch.where(den.abs() < 1e-20, 1.0, den)
    wb = fma(v2u, v1v, -(v1u * v2v)) / safe
    wc = fma(v0u, v2v, -(v2u * v0v)) / safe
    wa = 1.0 - wb - wc

    # coverage with the top-left fill rule
    s_sign = torch.sign(den)

    def accept(p0u, p0v, p1u, p1v):
        wq = fma(p1u - p0u, pv - p0v, -((p1v - p0v) * (pu - p0u))) * s_sign
        du = (p1u - p0u) * s_sign
        dv = (p1v - p0v) * s_sign
        tl = (dv < 0) | ((dv == 0) & (du < 0))
        return (wq > 0) | ((wq == 0) & tl)

    inside = (accept(au, av, bu, bv) & accept(bu, bv, cu, cv)
              & accept(cu, cv, au, av) & (den.abs() > 1e-20))
    valid = live & inside

    def lerp3(n0, n1, n2):
        # a*wa + b*wb + c*wc with the reference's fusion on the main path
        return fma(f(n2), wc, fma(f(n1), wb, f(n0) * wa))

    def lerp_uv(n0, n1, n2):
        # the reference fuses the other product for the texture uv
        return fma(f(n2), wc, fma(f(n0), wa, f(n1) * wb))

    return dict(uu=lerp_uv("ua", "ub", "uc"), vv=lerp_uv("va", "vb", "vc"),
                valid=valid, lerp3=lerp3)


def _tap_index(uu, vv, mid, lod, geom, k):
    """Packed atlas row + sub-slot + bilinear fractions of the 2x2 footprint
    at (uu, vv) in mip level ``lod`` (REPEAT wrap)."""
    levels = len(geom)
    lvl = torch.clamp(lod.to(torch.int32), 0, levels - 1)
    lh = torch.full_like(lvl, geom[0][1]) >> lvl
    lw = torch.full_like(lvl, geom[0][2]) >> lvl
    off = torch.full_like(lvl, geom[0][0])
    hw_pad = torch.full_like(lvl, geom[0][3])
    for i in range(1, levels):
        sel = lvl == i
        off = torch.where(sel, geom[i][0], off)
        hw_pad = torch.where(sel, geom[i][3], hw_pad)
    uw = uu - torch.floor(uu)
    vw = vv - torch.floor(vv)
    u = fma(uw, lw.to(torch.float32), -0.5)
    v = fma(vw, lh.to(torch.float32), -0.5)
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fu = u - u0
    fv = v - v0
    u0i = _to_index(u0)
    v0i = _to_index(v0)
    u0i = u0i + torch.where(u0i < 0, lw, 0)
    v0i = v0i + torch.where(v0i < 0, lh, 0)
    texel = mid.to(torch.int32) * hw_pad + v0i * lw + u0i
    return off + torch.div(texel, k, rounding_mode="floor"), texel % k, fu, fv


def _index_math(geo, meta, *, res, geom, k):
    """Plain version of K1 on per-slot geometry rows: (N,) int32 atlas row,
    0 where the slot is not valid."""
    s = _slot_uv(geo, meta, res)
    row, _, _, _ = _tap_index(s["uu"], s["vv"], geo[REC["mid"]],
                              geo[REC["lod"]], geom, k)
    return torch.where(s["valid"], row, 0)


def _fragment_math(rec, taps, meta, *, res, geom, k,
                   has_base, has_normal, has_mr):
    """Plain version of K2: per-slot records (REC_W, N), f32 taps
    (k*4*TAPS_C, N) or None, meta (4, N) -> (OUT_W, N)."""
    f = lambda name: rec[REC[name]]  # noqa: E731
    s = _slot_uv(rec, meta, res)
    lerp3 = s["lerp3"]

    px, py, pz = (lerp3("pax", "pbx", "pcx"), lerp3("pay", "pby", "pcy"),
                  lerp3("paz", "pbz", "pcz"))
    nx, ny, nz = (lerp3("nax", "nbx", "ncx"), lerp3("nay", "nby", "ncy"),
                  lerp3("naz", "nbz", "ncz"))
    tx_, ty_, tz_, tw_ = (
        lerp3("tax", "tbx", "tcx"), lerp3("tay", "tby", "tcy"),
        lerp3("taz", "tbz", "tcz"), lerp3("taw", "tbw", "tcw"),
    )

    if has_base or has_normal or has_mr:
        _, sub, fu, fv = _tap_index(s["uu"], s["vv"], f("mid"), f("lod"),
                                    geom, k)
        g = 4 * TAPS_C
        group = taps[0:g]
        for j in range(1, k):
            group = torch.where(sub == j, taps[j * g:(j + 1) * g], group)
        c = TAPS_C
        t00, t01 = group[0:c], group[c:2 * c]
        t10, t11 = group[2 * c:3 * c], group[3 * c:4 * c]
        # the reference's sum of four products, as its arithmetic fuses it
        mix = fma(t11 * fu, fv, fma(t10 * (1 - fu), fv,
                                    fma(t00 * (1 - fu), 1 - fv,
                                        t01 * fu * (1 - fv))))
        s_albedo, s_normal, s_mr = mix[0:4], mix[4:7], mix[7:10]

    factor = torch.stack([f("fr"), f("fg"), f("fb"), f("fa")])
    color = s_albedo * factor if has_base else factor

    def rsqrt(x):  # IEEE 1/sqrt, as the kernel computes it
        return 1.0 / sqrt(x)

    if has_normal:
        mx = s_normal[0] * 2.0 - 1.0
        my = s_normal[1] * 2.0 - 1.0
        mz = s_normal[2] * 2.0 - 1.0
        rinv = rsqrt(mx * mx + my * my + mz * mz + 1e-24)
        mx, my, mz = mx * rinv, my * rinv, mz * rinv
        rinv = rsqrt(nx * nx + ny * ny + nz * nz + 1e-24)
        ux, uy, uz = nx * rinv, ny * rinv, nz * rinv
        bx = uy * tz_ - uz * ty_
        by = uz * tx_ - ux * tz_
        bz = ux * ty_ - uy * tx_
        rinv = rsqrt(bx * bx + by * by + bz * bz + 1e-24)
        bx, by, bz = bx * rinv * tw_, by * rinv * tw_, bz * rinv * tw_
        ox = tx_ * mx + bx * my + ux * mz
        oy = ty_ * mx + by * my + uy * mz
        oz = tz_ * mx + bz * my + uz * mz
        rinv = rsqrt(ox * ox + oy * oy + oz * oz + 1e-24)
        ox, oy, oz = ox * rinv, oy * rinv, oz * rinv
    else:
        ox, oy, oz = nx, ny, nz

    if has_mr:
        metal, rough = s_mr[2], s_mr[1]
    else:
        metal = torch.full_like(px, 0.1)
        rough = torch.full_like(px, 0.5)

    return torch.stack([
        px, py, pz, color[0], color[1], color[2], color[3],
        f("sx"), f("sy"), f("sz"), ox, oy, oz,
        f("qw"), f("qx"), f("qy"), f("qz"), metal, rough,
        s["valid"].to(torch.float32),
    ])


def _gather_rec(records, metaT, rows=None):
    """Per-slot record rows (records[:rows, tri]) for the plain versions."""
    rec = records if rows is None else records[:rows]
    return rec[:, metaT[0].long()]


def slot_local(metaT):
    """Each slot's index within its texel-row segment, (cap,) f32 (exact
    below 2^24): a segment starts at slot 0 and wherever the slot's
    (tri, row_local) differs from the previous slot's, the rule of the JAX
    package's in-kernel ``_local_scan``. Slot allocation is triangle-ordered
    and the slots past ``total`` repeat the last key, so this equals the
    forward fill of each row producer's first slot (``segments``)."""
    tri = metaT[0].to(torch.int32)
    row = metaT[1].to(torch.int32)
    slot = torch.arange(tri.shape[0], dtype=torch.int32, device=tri.device)
    new = slot == 0
    new[1:] |= (tri[1:] != tri[:-1]) | (row[1:] != row[:-1])
    start = torch.cummax(torch.where(new, slot, 0), 0).values
    return (slot - start).to(torch.float32)


def texel_rows_plain(records, metaT, *, res, geom, k, n_rows):
    """Plain version of K1 on any device. Writes ``slot_local`` into row 2
    of ``metaT``, as the kernel does."""
    metaT[2] = slot_local(metaT)
    idx = _index_math(_gather_rec(records, metaT, GEO_W), metaT,
                      res=res, geom=geom, k=k)
    return torch.clamp(idx, 0, n_rows - 1)


def texel_rows(records, metaT, *, res, geom, k, n_rows):
    """K1: per-slot packed atlas row indices, (cap,) int32 in [0, n_rows).
    records: (REC_W, T_pad) f32; metaT: (4, cap) f32 [tri, row_local,
    local, live] whose rows 0 and 1 never decrease together along the slots
    (lexicographically), as the conversion allocates them. Also computes
    each slot's ``local`` (``slot_local``) and writes it into row 2 of
    ``metaT``, where K2 reads it: row 2 is not read. A CUDA tensor launches
    the kernel, a CPU tensor takes the plain version."""
    kw = dict(res=res, geom=geom, k=k, n_rows=n_rows)
    if records.is_cuda:
        return kernels.texel_rows(records, metaT, **kw)
    return texel_rows_plain(records, metaT, **kw)


def fragment_apply_plain(records, tapsT, metaT, *, res, geom, k, has_base,
                         has_normal, has_mr, taps_packed,
                         local_in_kernel=False, rows=None):
    """Plain version of K2 on any device: (OUT_W, cap) f32. With rows,
    tapsT is the tap atlas and the taps are its columns rows
    (``index_select``). With local_in_kernel it first writes
    ``slot_local`` into row 2 of ``metaT``, as the kernel does."""
    if local_in_kernel:
        metaT[2] = slot_local(metaT)
    taps = None
    if has_base or has_normal or has_mr:
        if rows is not None:
            tapsT = tapsT.index_select(1, rows)
        taps = _unpack_taps(tapsT) if taps_packed else tapsT
    return _fragment_math(
        _gather_rec(records, metaT), taps, metaT, res=res, geom=geom, k=k,
        has_base=has_base, has_normal=has_normal, has_mr=has_mr,
    )


class _FragmentApply(torch.autograd.Function):
    """K2 forward (the kernel on a CUDA tensor, the plain version on a CPU
    tensor); backward = the VJP of ``_fragment_math``, from the metaT the
    forward leaves (with local_in_kernel, its row 2 then holds local). With
    rows it saves the atlas and rows, not gathered taps, and its backward
    gathers them again under autograd, so the gradient reaches the atlas
    through ``index_select``'s own VJP. The backward runs in the span
    ``m2s.convert.fragment_vjp``."""

    @staticmethod
    def forward(ctx, records, tapsT, metaT, rows, kw):
        if records.is_cuda:
            out = kernels.fragment_apply(records, tapsT, metaT, rows=rows,
                                         **kw)
        else:
            out = fragment_apply_plain(records, tapsT, metaT, rows=rows, **kw)
        ctx.save_for_backward(records, tapsT, metaT, rows)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, g_out):
        with annotate("m2s.convert.fragment_vjp"):
            records, tapsT, metaT, rows = ctx.saved_tensors
            kw = dict(ctx.kw)
            packed = kw.pop("taps_packed")
            del kw["local_in_kernel"]
            has_stack = kw["has_base"] or kw["has_normal"] or kw["has_mr"]
            want_taps = has_stack and not packed and ctx.needs_input_grad[1]
            with torch.enable_grad():
                rec = records.detach().requires_grad_(ctx.needs_input_grad[0])
                src = taps = None
                if has_stack:
                    src = tapsT.detach().requires_grad_(want_taps)
                    taps = src if rows is None else src.index_select(1, rows)
                    if packed:
                        taps = _unpack_taps(taps)
                out = _fragment_math(_gather_rec(rec, metaT), taps, metaT,
                                     **kw)
                inputs = [t for t, need in ((rec, ctx.needs_input_grad[0]),
                                            (src, want_taps)) if need]
                grads = iter(torch.autograd.grad(out, inputs, g_out,
                                                 allow_unused=True)
                             if inputs else ())
            d_rec = next(grads) if ctx.needs_input_grad[0] else None
            d_taps = next(grads) if want_taps else None
            return d_rec, d_taps, None, None, None


def fragment_apply(records, tapsT, metaT, res, geom, k,
                   has_base, has_normal, has_mr, taps_packed=False,
                   local_in_kernel=False, rows=None):
    """K2: the fragment shader over all slots. records (REC_W, T_pad) f32;
    tapsT (k*4*TAPS_C, cap) f32 gathered taps, or (k*4*TAPS_C/2, cap) int32
    bf16 pairs when taps_packed, or any dummy when the material has no
    texture; with rows ((cap,) int32, K1's texel_rows), tapsT is instead
    the tap atlas (k*4*TAPS_C[/2], n_rows) and slot i's taps are its column
    rows[i] (the kernel reads them there: no gathered copy is made); metaT
    (4, cap) f32 [tri, row_local, local, live]. local_in_kernel: row 2 is
    not read; K2 computes each slot's local (``slot_local``; rows 0 and 1
    must never decrease together along the slots, as the conversion
    allocates them) and writes it there, as the JAX kernel B returns it.
    Returns ((OUT_W, cap) f32, (1, cap) f32 local). A CUDA tensor launches
    the kernel, a CPU tensor takes the plain version; either way the
    gradient flows to records and f32 taps (with rows, to the atlas)."""
    kw = dict(res=res, geom=geom, k=k, has_base=has_base,
              has_normal=has_normal, has_mr=has_mr, taps_packed=taps_packed,
              local_in_kernel=local_in_kernel)
    return (_FragmentApply.apply(records, tapsT, metaT, rows, kw),
            metaT[2:3])
