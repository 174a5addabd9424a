"""Per-tile front-to-back compositing and its VJP (counterpart of
``mesh2splat_tpu.render.composite``: kernel K3 forward, kernel K4 backward).

Each (32, 32)-pixel tile walks its depth-ordered pair list in chunks of
CHUNK = 128 pairs, from ``aligned = (start // CHUNK) * CHUNK``, masking rows
outside [start, end). Two transmittance chains: T_a over the alpha group
(channels 0-3, 8-11) and T_g over the g group (4-7, 12-13). After each chunk
the tile stops once the largest T_a over its 1024 pixels (padding pixels
included) is <= 1/255.

G-buffer channel layout (16, H, W):
  0-2 albedo rgb premult | 3 alpha-acc (a*g group) | 4-6 wsPos premult
  7 g-acc | 8-10 encoded normal premult | 11 view depth premult
  12 metallic | 13 roughness | 14 T_a | 15 T_g

The backward is the suffix trick of the JAX package (its header, "The
backward pass is the differentiable-3DGS suffix trick"): per pixel,
res_a = dot(out, ct) over the alpha group + ct_Ta * T_a (res_g likewise for
the g group); a second front-to-back walk over every chunk of the tile (no
early exit) carries T_a, T_g and the inclusive prefixes Bpref_a, Bpref_g;
dL/dalpha-plane = -(res_a - Bpref_a) / (1 - min(alpha*g, 0.9999)), and the
per-pixel terms reduce over the tile's pixels into moments of the falloff
power, which chain to the mean and conic rows.

A CUDA tensor launches the hand-written kernels (``kernels.composite_forward``
and ``kernels.composite_backward``); a CPU tensor takes ``composite_plain``
and ``composite_backward_plain``, which do the same arithmetic over batches
of tiles.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..ops.projection import axes_from_conic
from . import binning as B

TILE_H = B.TILE_H
TILE_W = B.TILE_W
NPX = TILE_H * TILE_W
NUM_CH = 16
CHUNK = B.CHUNK
CH_TA, CH_TG = 14, 15
ALPHA_GROUP = (0, 1, 2, 3, 8, 9, 10, 11)
G_GROUP = (4, 5, 6, 7, 12, 13)
MIN_T = 1.0 / 255.0


def _check_inputs(fields, tile_starts, ty, tx, albedo_only):
    variant = "albedo" if albedo_only else "full"
    if fields.dim() != 2 or fields.shape[0] != B.padded_rows(variant):
        raise ValueError(
            f"fields {tuple(fields.shape)}: expected ({B.padded_rows(variant)}"
            f", P) for the {variant!r} variant"
        )
    if fields.shape[1] % CHUNK:
        raise ValueError(
            f"fields pair axis {fields.shape[1]} must be a multiple of "
            f"CHUNK={CHUNK} (bin_pairs pads automatically)"
        )
    if tile_starts.shape != (ty * tx + 1,):
        raise ValueError(
            f"tile_starts {tuple(tile_starts.shape)}: expected ({ty * tx + 1},)"
        )


def _pixel_coords(device):
    q = torch.arange(NPX, device=device)
    x = (q % TILE_W).to(torch.float32) + 0.5
    y = torch.div(q, TILE_W, rounding_mode="floor").to(torch.float32) + 0.5
    return x, y, x * x, x * y, y * y


def _chunk_planes(col, tjf, py0, pix, live):
    """Coverage-masked falloff g (nb, CHUNK, NPX) of one chunk per tile,
    and the tile-local means mxp, myp (nb, CHUNK, 1). col(name) ->
    (nb, CHUNK, 1); tjf, py0: (nb, 1, 1); live (nb, CHUNK, 1)."""
    x, y, xx, xy, yy = pix
    ca, cb, cc = col("conic_a"), col("conic_b"), col("conic_c")
    mxp = col("mean_x") - tjf
    myp = col("mean_y") - py0
    mjx, mjy, mnx, mny = axes_from_conic(ca, cb, cc)
    det = mjx * mny - mnx * mjy
    det = torch.where(det.abs() < 1e-12, 1e-12, det)
    rdet = 1.0 / det
    c_pw = (
        -(0.5 * ca * mxp * mxp + cb * mxp * myp + 0.5 * cc * myp * myp),
        ca * mxp + cb * myp,
        -(cb * mxp + cc * myp),
        -0.5 * ca,
        cb,
        -0.5 * cc,
    )
    c_u = (rdet * (mnx * myp - mny * mxp), rdet * mny, rdet * mnx)
    c_v = (rdet * (mxp * mjy - mjx * myp), -rdet * mjy, -rdet * mjx)
    pw = (c_pw[0] + c_pw[1] * x + c_pw[2] * y + c_pw[3] * xx
          + c_pw[4] * xy + c_pw[5] * yy)
    u = c_u[0] + c_u[1] * x + c_u[2] * y
    v = c_v[0] + c_v[1] * x + c_v[2] * y
    inside = (torch.maximum(u.abs(), v.abs()) <= 1.0) & live
    g = torch.where(inside, torch.exp(torch.minimum(pw, torch.zeros_like(pw))),
                    0.0)
    return g, mxp, myp


def _incl_cumsum(x):
    """Inclusive prefix sum along the pair axis (dim 1), added in pair
    order as the kernel's running sum is."""
    out = torch.empty_like(x)
    run = torch.zeros_like(x[:, 0])
    for r in range(x.shape[1]):
        run = run + x[:, r]
        out[:, r] = run
    return out


def _excl_cumprod(x):
    """Exclusive prefix product along the pair axis (dim 1), multiplied in
    pair order as the kernel's running product is (torch.cumprod on a CUDA
    tensor multiplies in another order)."""
    out = torch.empty_like(x)
    run = torch.ones_like(x[:, 0])
    for r in range(x.shape[1]):
        out[:, r] = run
        run = run * x[:, r]
    return out


def _tile_ranges(tile_starts):
    starts = tile_starts[:-1].long()
    ends = tile_starts[1:].long()
    aligned = torch.div(starts, CHUNK, rounding_mode="floor") * CHUNK
    num_chunks = torch.where(
        ends > starts,
        torch.div(ends - aligned + CHUNK - 1, CHUNK, rounding_mode="floor"), 0)
    return starts, ends, aligned, num_chunks


def _tile_origin(tiles, tx, height):
    ti = torch.div(tiles, tx, rounding_mode="floor")
    tj = tiles % tx
    tjf = (tj.to(torch.float32) * TILE_W)[:, None, None]
    py0 = (float(height) - ti.to(torch.float32) * TILE_H)[:, None, None]
    return tjf, py0


def composite_plain(fields, tile_starts, height, ty, tx, albedo_only,
                    tile_batch=256):
    """Plain version of K3: loops over chunk index c for a batch of tiles at
    once, with the kernel's chunk-boundary early exit. Returns
    (16, ty*32, tx*32)."""
    idx = B.field_index("albedo" if albedo_only else "full")
    dev = fields.device
    p_cap = fields.shape[1]
    n_tiles = ty * tx
    starts, ends, aligned, num_chunks = _tile_ranges(tile_starts)
    pix = _pixel_coords(dev)
    lane = torch.arange(CHUNK, device=dev)
    out = torch.zeros((n_tiles, NUM_CH, NPX), dtype=torch.float32, device=dev)

    for b0 in range(0, n_tiles, tile_batch):
        tiles = torch.arange(b0, min(b0 + tile_batch, n_tiles), device=dev)
        nb = tiles.shape[0]
        tjf, py0 = _tile_origin(tiles, tx, height)
        acc = torch.zeros((nb, NUM_CH, NPX), dtype=torch.float32, device=dev)
        acc[:, CH_TA] = 1.0
        acc[:, CH_TG] = 1.0
        s, e, al, nc = starts[tiles], ends[tiles], aligned[tiles], num_chunks[tiles]
        for c in range(int(nc.max()) if nb else 0):
            active = (c < nc) & (acc[:, CH_TA].amax(dim=1) > MIN_T)
            if not bool(active.any()):
                break
            rows = al[:, None] + c * CHUNK + lane  # (nb, CHUNK)
            live = (rows >= s[:, None]) & (rows < e[:, None]) & active[:, None]
            st = fields[:, rows.clamp(max=p_cap - 1)]  # (F, nb, CHUNK)

            def col(name):
                return st[idx[name]][..., None]

            g, _, _ = _chunk_planes(col, tjf, py0, pix, live[..., None])
            agr = col("alpha") * g
            ag = torch.minimum(agr, torch.full_like(agr, 0.9999))
            om = 1.0 - ag
            cum = _excl_cumprod(om)
            e_a = cum * acc[:, CH_TA:CH_TA + 1]
            agw = agr * e_a
            c_a = torch.stack([st[idx["col_r"]], st[idx["col_g"]],
                               st[idx["col_b"]],
                               torch.ones_like(st[idx["col_r"]])], dim=-1)
            acc[:, 0:4] += torch.einsum("bpc,bpn->bcn", c_a, agw)
            if not albedo_only:
                gw_a = g * e_a
                omg = 1.0 - g
                cumg = _excl_cumprod(omg)
                gw_g = g * (cumg * acc[:, CH_TG:CH_TG + 1])
                c_n = torch.stack([st[idx[n]] for n in
                                   ("nrm_x", "nrm_y", "nrm_z", "depth")], -1)
                acc[:, 8:12] += torch.einsum("bpc,bpn->bcn", c_n, gw_a)
                c_g = torch.stack([st[idx["ws_x"]], st[idx["ws_y"]],
                                   st[idx["ws_z"]],
                                   torch.ones_like(st[idx["ws_x"]]),
                                   st[idx["metal"]], st[idx["rough"]]], -1)
                gvals = torch.einsum("bpc,bpn->bcn", c_g, gw_g)
                acc[:, 4:8] += gvals[:, 0:4]
                acc[:, 12:14] += gvals[:, 4:6]
                acc[:, CH_TG] *= cumg[:, -1] * omg[:, -1]
            acc[:, CH_TA] *= cum[:, -1] * om[:, -1]
        if albedo_only:
            acc[:, CH_TG] = 1.0
        out[b0:b0 + nb] = acc
    return (out.reshape(ty, tx, NUM_CH, TILE_H, TILE_W)
            .permute(2, 0, 3, 1, 4).reshape(NUM_CH, ty * TILE_H, tx * TILE_W))


def _to_tiles(img, ty, tx):
    """(ch, ty*32, tx*32) image -> (ty*tx, ch, NPX) tile rows."""
    ch = img.shape[0]
    return (img.reshape(ch, ty, TILE_H, tx, TILE_W).permute(1, 3, 0, 2, 4)
            .reshape(ty * tx, ch, NPX))


def backward_totals(out, ct):
    """(2, H, W): per pixel res_a = sum over the alpha group of out * ct plus
    the T_a channel's own ct * T_a, and res_g likewise for the g group."""
    res_a = sum(out[c] * ct[c] for c in ALPHA_GROUP) + ct[CH_TA] * out[CH_TA]
    res_g = sum(out[c] * ct[c] for c in G_GROUP) + ct[CH_TG] * out[CH_TG]
    return torch.stack([res_a, res_g])


@torch.no_grad()
def composite_backward_plain(fields, tile_starts, out, ct, height, ty, tx,
                             albedo_only, tile_batch=64):
    """Plain version of K4: dfields (F_pad, P) from the forward's fields,
    tile_starts and output ``out`` (16, ty*32, tx*32) and its cotangent
    ``ct`` (same shape). Walks every chunk of each tile (no early exit);
    rows outside every tile's [start, end), and so every row >= num_pairs,
    get zero. It is itself the gradient: it records no autograd graph."""
    full = not albedo_only
    idx = B.field_index("albedo" if albedo_only else "full")
    dev = fields.device
    p_cap = fields.shape[1]
    n_tiles = ty * tx
    starts, ends, aligned, num_chunks = _tile_ranges(tile_starts)
    x, y, xx, xy, yy = _pixel_coords(dev)
    feats = torch.stack([torch.ones_like(x), x, y, xx, xy, yy])  # (6, NPX)
    ct_t = _to_tiles(ct, ty, tx)
    res_t = _to_tiles(backward_totals(out, ct), ty, tx)
    lane = torch.arange(CHUNK, device=dev)
    dfields = torch.zeros_like(fields)

    for b0 in range(0, n_tiles, tile_batch):
        tiles = torch.arange(b0, min(b0 + tile_batch, n_tiles), device=dev)
        nb = tiles.shape[0]
        tjf, py0 = _tile_origin(tiles, tx, height)
        ctb = ct_t[b0:b0 + nb][:, :, None, :]          # (nb, 16, 1, NPX)
        res_a = res_t[b0:b0 + nb, 0][:, None, :]       # (nb, 1, NPX)
        res_g = res_t[b0:b0 + nb, 1][:, None, :]
        t_a = torch.ones((nb, 1, NPX), dtype=torch.float32, device=dev)
        t_g = torch.ones_like(t_a)
        bp_a = torch.zeros_like(t_a)
        bp_g = torch.zeros_like(t_a)
        s, e, al, nc = starts[tiles], ends[tiles], aligned[tiles], num_chunks[tiles]
        for c in range(int(nc.max()) if nb else 0):
            rows = al[:, None] + c * CHUNK + lane  # (nb, CHUNK)
            live = (rows >= s[:, None]) & (rows < e[:, None]) & (c < nc)[:, None]
            st = fields[:, rows.clamp(max=p_cap - 1)]  # (F, nb, CHUNK)

            def col(name):
                return st[idx[name]][..., None]

            g, mxp, myp = _chunk_planes(col, tjf, py0, (x, y, xx, xy, yy),
                                        live[..., None])
            alpha = col("alpha")
            agr = alpha * g
            ag = torch.minimum(agr, torch.full_like(agr, 0.9999))
            om = 1.0 - ag
            cum = _excl_cumprod(om)
            e_a = cum * t_a
            gw_a = g * e_a
            ct_rgb3 = (col("col_r") * ctb[:, 0] + col("col_g") * ctb[:, 1]
                       + col("col_b") * ctb[:, 2] + ctb[:, 3])
            sdot_a = alpha * ct_rgb3
            if full:
                sdot_a = sdot_a + (col("nrm_x") * ctb[:, 8]
                                   + col("nrm_y") * ctb[:, 9]
                                   + col("nrm_z") * ctb[:, 10]
                                   + col("depth") * ctb[:, 11])
            bpref_a = bp_a + _incl_cumsum(sdot_a * gw_a)
            da = -(res_a - bpref_a) / (1.0 - ag)
            dl_dg = sdot_a * e_a + da * alpha
            if full:
                omg = 1.0 - g
                cumg = _excl_cumprod(omg)
                e_g = cumg * t_g
                gw_g = g * e_g
                sdot_g = (col("ws_x") * ctb[:, 4] + col("ws_y") * ctb[:, 5]
                          + col("ws_z") * ctb[:, 6] + ctb[:, 7]
                          + col("metal") * ctb[:, 12]
                          + col("rough") * ctb[:, 13])
                bpref_g = bp_g + _incl_cumsum(sdot_g * gw_g)
                dgg = -(res_g - bpref_g) / torch.clamp(omg, min=1e-4)
                dl_dg = dl_dg + sdot_g * e_g + dgg
            gp = dl_dg * g                            # dL/dpower
            dal = g * (ct_rgb3 * e_a + da)            # dL/dalpha plane
            m0, mx, my, mxx, mxy, myy = torch.einsum(
                "bpn,kn->kbp", gp, feats)[..., None]
            ca, cb, cc = col("conic_a"), col("conic_b"), col("conic_c")
            gx = mxp * m0 - mx                        # sum gp * dx
            gy = myp * m0 + my                        # sum gp * dy
            grads = {
                "mean_x": -(ca * gx + cb * gy),
                "mean_y": -(cc * gy + cb * gx),
                "conic_a": -0.5 * (mxp * mxp * m0 - 2.0 * mxp * mx + mxx),
                "conic_b": -(mxp * myp * m0 + mxp * my - myp * mx - mxy),
                "conic_c": -0.5 * (myp * myp * m0 + 2.0 * myp * my + myy),
                "alpha": dal.sum(-1, keepdim=True),
            }
            w_rgb = agr * e_a
            for i, name in enumerate(("col_r", "col_g", "col_b")):
                grads[name] = (w_rgb * ctb[:, i]).sum(-1, keepdim=True)
            if full:
                for i, name in zip((8, 9, 10, 11),
                                   ("nrm_x", "nrm_y", "nrm_z", "depth")):
                    grads[name] = (gw_a * ctb[:, i]).sum(-1, keepdim=True)
                for i, name in zip((4, 5, 6, 12, 13),
                                   ("ws_x", "ws_y", "ws_z", "metal", "rough")):
                    grads[name] = (gw_g * ctb[:, i]).sum(-1, keepdim=True)
                t_g = t_g * cumg[:, -1:] * omg[:, -1:]
                bp_g = bpref_g[:, -1:]
            t_a = t_a * cum[:, -1:] * om[:, -1:]
            bp_a = bpref_a[:, -1:]
            dst = rows[live]
            for name, gval in grads.items():
                dfields[idx[name], dst] = gval[..., 0][live]
    return dfields


class _Composite(torch.autograd.Function):
    """K3 forward, K4 backward: the CUDA kernels for CUDA tensors, the plain
    versions for CPU tensors."""

    @staticmethod
    def forward(ctx, fields, tile_starts, height, ty, tx, albedo_only):
        if fields.is_cuda:
            out = kernels.composite_forward(fields, tile_starts, height=height,
                                            ty=ty, tx=tx,
                                            albedo_only=albedo_only)
        else:
            out = composite_plain(fields, tile_starts, height, ty, tx,
                                  albedo_only)
        ctx.save_for_backward(fields, tile_starts, out)
        ctx.meta = (height, ty, tx, albedo_only)
        return out

    @staticmethod
    def backward(ctx, ct):
        fields, tile_starts, out = ctx.saved_tensors
        height, ty, tx, albedo_only = ctx.meta
        ct = ct.contiguous()
        if fields.is_cuda:
            res = backward_totals(out, ct).contiguous()
            dfields = kernels.composite_backward(
                fields, tile_starts, ct, res, height=height, ty=ty, tx=tx,
                albedo_only=albedo_only)
        else:
            dfields = composite_backward_plain(fields, tile_starts, out, ct,
                                               height, ty, tx, albedo_only)
        return dfields, None, None, None, None, None


def composite_tiles(fields, tile_starts, height, ty, tx, albedo_only=False):
    """fields: (F_pad, P) from binning (variant "albedo" if albedo_only else
    "full"); returns the (16, ty*32, tx*32) G-buffer. Differentiable with
    respect to fields."""
    _check_inputs(fields, tile_starts, ty, tx, albedo_only)
    return _Composite.apply(fields, tile_starts, height, ty, tx, albedo_only)
