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

The forward-only walkers (kernel K5 ``min_depth_tiles``, kernel K6
``overdraw_tiles``) walk every chunk of each tile (no early exit) and keep,
per pixel, the minimum ``depth`` field over the covering pairs (3e38 where
none) or the count of covering pairs. A pair covers a pixel where its
falloff g is above 0 (inside the quad and not underflowed), the coverage of
the composite. Both are order-free.

The kernels K3 and K4 skip, for each warp's 8x4-pixel cull block, the pairs
whose quad provably misses every pixel of the block (``cull_plain`` is the
rule's plain mirror, which the tests hold to the coverage of
``_chunk_planes``); a skipped pair adds nothing, so the plain versions need
no cull. K4 walks a tile's chunks in segments over several blocks, each
segment starting from the states of the ones before it
(``segment_states_plain``; ``composite_backward_plain(seg_chunks=)`` walks
the same way).

A CUDA tensor launches the hand-written kernels (``kernels.composite_forward``,
``kernels.composite_backward``, ``kernels.min_depth``, ``kernels.overdraw``);
a CPU tensor takes ``composite_plain``, ``composite_backward_plain``,
``min_depth_plain`` and ``overdraw_plain``, which do the same arithmetic
over batches of tiles.
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


def _check_inputs(fields, tile_starts, ty, tx, variant):
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


def _planes(col, tjf, py0):
    """The plane coefficients of one chunk per tile, in the tile-local pixel
    basis: the falloff power's c_pw (6 terms of [1, x, y, x^2, x*y, y^2]),
    the quad's c_u and c_v (3 terms of [1, x, y]), and the tile-local means
    mxp, myp. col(name) -> (nb, CHUNK, 1); tjf, py0: (nb, 1, 1)."""
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
    return c_pw, c_u, c_v, mxp, myp


def _quad_inside(c_u, c_v, x, y):
    """Whether pixel centre (x, y) lies in the pair's quad: |u|, |v| <= 1."""
    u = c_u[0] + c_u[1] * x + c_u[2] * y
    v = c_v[0] + c_v[1] * x + c_v[2] * y
    return torch.maximum(u.abs(), v.abs()) <= 1.0


def _chunk_planes(col, tjf, py0, pix, live):
    """Coverage-masked falloff g (nb, CHUNK, NPX) of one chunk per tile,
    and the tile-local means mxp, myp (nb, CHUNK, 1). col(name) ->
    (nb, CHUNK, 1); tjf, py0: (nb, 1, 1); live (nb, CHUNK, 1)."""
    x, y, xx, xy, yy = pix
    c_pw, c_u, c_v, mxp, myp = _planes(col, tjf, py0)
    pw = (c_pw[0] + c_pw[1] * x + c_pw[2] * y + c_pw[3] * xx
          + c_pw[4] * xy + c_pw[5] * yy)
    inside = _quad_inside(c_u, c_v, x, y) & live
    g = torch.where(inside, torch.exp(torch.minimum(pw, torch.zeros_like(pw))),
                    0.0)
    return g, mxp, myp


# K3 and K4 cull a chunk's pairs against blocks of 8x4 pixels, 32 to a
# tile: block b holds the pixels [8 (b % 4), +8) x [4 (b // 4), +4), and the
# warp that walks it only the pairs the cull keeps
# (kernels/csrc/composite_common.cuh).
BLOCK_W, BLOCK_H = 8, 4
NUM_BLOCKS = (TILE_W // BLOCK_W) * (TILE_H // BLOCK_H)
CULL_EPS = 2.0 ** -20   # the cull's relative margin (its derivation: the .cuh)


def _plane_reaches(c0, c1, c2, xc, yc):
    """Whether c0 + c1 x + c2 y may lie in [-1, 1] at a pixel centre of the
    block centred at (xc, yc): the kernels' plane_reaches(), the same f32
    operations in the same order. NaN keeps the pair."""
    mid = c0 + c1 * xc + c2 * yc
    half = c1.abs() * (BLOCK_W / 2 - 0.5) + c2.abs() * (BLOCK_H / 2 - 0.5)
    margin = (c0.abs() + 32.0 * (c1.abs() + c2.abs()) + 1.0) * CULL_EPS
    return ~(mid.abs() - half > 1.0 + margin)


def cull_plain(c_u, c_v):
    """Plain version of the kernels' cull: a (..., NUM_BLOCKS) bool, True
    where the pair (its quad's u and v planes c_u, c_v: triples of (...)
    f32 tensors from ``_planes``) covers no pixel of cull block b. It is
    conservative: a dropped pair covers no pixel of the block. Nothing on
    the main path calls it; the tests hold the rule to the coverage of
    ``_chunk_planes``."""
    per_row = TILE_W // BLOCK_W
    out = []
    for b in range(NUM_BLOCKS):
        xc = float((b % per_row) * BLOCK_W + BLOCK_W // 2)
        yc = float((b // per_row) * BLOCK_H + BLOCK_H // 2)
        out.append(~(_plane_reaches(*c_u, xc, yc)
                     & _plane_reaches(*c_v, xc, yc)))
    return torch.stack(out, dim=-1)


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
                    tile_batch=256, return_walked=False):
    """Plain version of K3: loops over chunk index c for a batch of tiles at
    once, with the kernel's chunk-boundary early exit. Returns
    (16, ty*32, tx*32); with ``return_walked`` also the (ty*tx,) int32
    count of the pairs each tile walked before its early exit, counted as
    the kernel counts them: the rows of its range up to the end of its last
    walked chunk."""
    idx = B.field_index("albedo" if albedo_only else "full")
    dev = fields.device
    p_cap = fields.shape[1]
    n_tiles = ty * tx
    starts, ends, aligned, num_chunks = _tile_ranges(tile_starts)
    pix = _pixel_coords(dev)
    lane = torch.arange(CHUNK, device=dev)
    out = torch.zeros((n_tiles, NUM_CH, NPX), dtype=torch.float32, device=dev)
    chunks_walked = torch.zeros(n_tiles, dtype=torch.int64, device=dev)

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
            chunks_walked[b0:b0 + nb] += active
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
    img = (out.reshape(ty, tx, NUM_CH, TILE_H, TILE_W)
           .permute(2, 0, 3, 1, 4).reshape(NUM_CH, ty * TILE_H, tx * TILE_W))
    if not return_walked:
        return img
    hi = torch.minimum(aligned + chunks_walked * CHUNK, ends)
    walked = torch.where(num_chunks > 0, hi - starts, 0).to(torch.int32)
    return img, walked


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
                             albedo_only, tile_batch=64, seg_chunks=None):
    """Plain version of K4: dfields (F_pad, P) from the forward's fields,
    tile_starts and output ``out`` (16, ty*32, tx*32) and its cotangent
    ``ct`` (same shape). Walks every chunk of each tile (no early exit);
    rows outside every tile's [start, end), and so every row >= num_pairs,
    get zero. It is itself the gradient: it records no autograd graph.

    With ``seg_chunks``, the kernel's segmented walk: each segment of
    ``seg_chunks`` chunks (``kernels.segment_table``) starts from the
    states of the segments before it (``segment_states_plain``), folded in
    order, instead of the running T and Bpref."""
    states = None
    if seg_chunks:
        states, _ = segment_states_plain(fields, tile_starts, ct, height, ty,
                                         tx, albedo_only, seg_chunks,
                                         tile_batch)
    return _backward_walk(fields, tile_starts, ct, backward_totals(out, ct),
                          height, ty, tx, albedo_only, tile_batch,
                          seg_chunks, states)[0]


@torch.no_grad()
def segment_states_plain(fields, tile_starts, ct, height, ty, tx,
                         albedo_only, seg_chunks, tile_batch=64):
    """Plain version of K4's state pass: (states, last). states is
    (n_segments, 2 or 4, NPX): per segment of every tile, in the order of
    ``kernels.segment_table``, per pixel the T_a, Bpref_a (and T_g,
    Bpref_g) of a walk of that segment's chunks alone from T = 1,
    Bpref = 0; ``last`` marks each tile's last segment, whose state no
    segment needs (the kernel does not compute it)."""
    zero = torch.zeros((2,) + tuple(ct.shape[1:]), dtype=torch.float32,
                       device=ct.device)
    return _backward_walk(fields, tile_starts, ct, zero, height, ty, tx,
                          albedo_only, tile_batch, seg_chunks, None,
                          state_pass=True)[1]


def _backward_walk(fields, tile_starts, ct, res, height, ty, tx, albedo_only,
                   tile_batch, seg_chunks, states, state_pass=False):
    """The walk of K4 over batches of tiles: (dfields, (states, last)).
    Without ``seg_chunks`` one walk per tile carries T and Bpref through
    every chunk. With it, at the start of each segment but the first, the
    state pass resets T, Bpref to 1, 0 (and records every segment's end
    state), and the main pass takes the fold of ``states``."""
    full = not albedo_only
    idx = B.field_index("albedo" if albedo_only else "full")
    dev = fields.device
    p_cap = fields.shape[1]
    n_tiles = ty * tx
    starts, ends, aligned, num_chunks = _tile_ranges(tile_starts)
    x, y, xx, xy, yy = _pixel_coords(dev)
    feats = torch.stack([torch.ones_like(x), x, y, xx, xy, yy])  # (6, NPX)
    ct_t = _to_tiles(ct, ty, tx)
    res_t = _to_tiles(res, ty, tx)
    lane = torch.arange(CHUNK, device=dev)
    dfields = torch.zeros_like(fields)
    seg_out = last = seg_first = None
    if seg_chunks:
        seg_first = kernels.segment_table(tile_starts, seg_chunks).long()
        n_seg = int(seg_first[-1])
        last = torch.zeros(n_seg, dtype=torch.bool, device=dev)
        last[seg_first[1:][seg_first[1:] > seg_first[:-1]] - 1] = True
        if state_pass:
            seg_out = torch.full((n_seg, 4 if full else 2, NPX), float("nan"),
                                 dtype=torch.float32, device=dev)

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
            if seg_chunks and c % seg_chunks == 0 and c > 0:
                # segment k starts here in the tiles that still have chunks
                k = c // seg_chunks
                has = (c < nc)[:, None, None]
                one, zero = torch.ones_like(t_a), torch.zeros_like(t_a)
                if state_pass:
                    seg = seg_first[tiles] + k - 1   # the one that just ended
                    ended = torch.cat([t_a, bp_a]
                                      + ([t_g, bp_g] if full else []), dim=1)
                    seg_out[seg[c < nc]] = ended[c < nc]
                    n_a, n_g, nb_a, nb_g = one, one, zero, zero
                else:
                    n_a, n_g, nb_a, nb_g = one, one, zero, zero
                    for j in range(k):
                        sv = states[(seg_first[tiles] + j).clamp(
                            max=states.shape[0] - 1)]
                        nb_a = nb_a + n_a * sv[:, 1:2]
                        n_a = n_a * sv[:, 0:1]
                        if full:
                            nb_g = nb_g + n_g * sv[:, 3:4]
                            n_g = n_g * sv[:, 2:3]
                t_a, bp_a = torch.where(has, n_a, t_a), torch.where(has, nb_a, bp_a)
                t_g, bp_g = torch.where(has, n_g, t_g), torch.where(has, nb_g, bp_g)
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
            if not state_pass:
                dst = rows[live]
                for name, gval in grads.items():
                    dfields[idx[name], dst] = gval[..., 0][live]
        if state_pass:   # every tile's last segment ends with its walk
            busy = nc > 0
            ended = torch.cat([t_a, bp_a] + ([t_g, bp_g] if full else []),
                              dim=1)
            seg_out[(seg_first[tiles + 1] - 1)[busy]] = ended[busy]
    return dfields, (seg_out, last)


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
    _check_inputs(fields, tile_starts, ty, tx,
                  "albedo" if albedo_only else "full")
    return _Composite.apply(fields, tile_starts, height, ty, tx, albedo_only)


MIN_DEPTH_NONE = 3e38   # the min-depth value of a pixel no pair covers


def _single_channel_plain(fields, tile_starts, height, ty, tx, variant,
                          tile_batch):
    """The walk of K5 ("depth" variant: the minimum depth) and K6
    ("overdraw": the count) over batches of tiles, every chunk of each
    tile. Returns (1, ty*32, tx*32)."""
    idx = B.field_index(variant)
    min_depth = variant == "depth"
    dev = fields.device
    p_cap = fields.shape[1]
    n_tiles = ty * tx
    starts, ends, aligned, num_chunks = _tile_ranges(tile_starts)
    pix = _pixel_coords(dev)
    lane = torch.arange(CHUNK, device=dev)
    out = torch.empty((n_tiles, NPX), dtype=torch.float32, device=dev)
    for b0 in range(0, n_tiles, tile_batch):
        tiles = torch.arange(b0, min(b0 + tile_batch, n_tiles), device=dev)
        nb = tiles.shape[0]
        tjf, py0 = _tile_origin(tiles, tx, height)
        acc = torch.full((nb, NPX), MIN_DEPTH_NONE if min_depth else 0.0,
                         dtype=torch.float32, device=dev)
        s, e, al, nc = starts[tiles], ends[tiles], aligned[tiles], num_chunks[tiles]
        for c in range(int(nc.max()) if nb else 0):
            act = torch.nonzero(nc > c)[:, 0]   # the tiles with a chunk c
            rows = al[act, None] + c * CHUNK + lane  # (na, CHUNK)
            live = (rows >= s[act, None]) & (rows < e[act, None])
            st = fields[:, rows.clamp(max=p_cap - 1)]  # (F, na, CHUNK)
            g, _, _ = _chunk_planes(lambda name: st[idx[name]][..., None],
                                    tjf[act], py0[act], pix, live[..., None])
            cov = g > 0.0
            if min_depth:
                z = torch.where(cov, st[idx["depth"]][..., None],
                                MIN_DEPTH_NONE)
                acc[act] = torch.minimum(acc[act], z.amin(dim=1))
            else:
                acc[act] += cov.sum(dim=1).to(torch.float32)
        out[b0:b0 + nb] = acc
    return (out.reshape(ty, tx, TILE_H, TILE_W).permute(0, 2, 1, 3)
            .reshape(1, ty * TILE_H, tx * TILE_W))


@torch.no_grad()
def min_depth_plain(fields, tile_starts, height, ty, tx, tile_batch=256):
    """Plain version of K5 on "depth"-variant fields."""
    return _single_channel_plain(fields, tile_starts, height, ty, tx, "depth",
                                 tile_batch)


@torch.no_grad()
def overdraw_plain(fields, tile_starts, height, ty, tx, tile_batch=256):
    """Plain version of K6 on "overdraw"-variant fields."""
    return _single_channel_plain(fields, tile_starts, height, ty, tx,
                                 "overdraw", tile_batch)


def min_depth_tiles(binned: B.BinnedPairs, height, ty, tx):
    """(1, ty*32, tx*32) per-pixel minimum of depth over covering pairs,
    3e38 where none covers. Forward only. ``binned`` must use the "depth"
    field variant."""
    _check_inputs(binned.fields, binned.tile_starts, ty, tx, "depth")
    if binned.fields.is_cuda:
        return kernels.min_depth(binned.fields, binned.tile_starts,
                                 height=height, ty=ty, tx=tx)
    return min_depth_plain(binned.fields, binned.tile_starts, height, ty, tx)


def overdraw_tiles(binned: B.BinnedPairs, height, ty, tx):
    """(1, ty*32, tx*32) per-pixel count of covering pairs (the caller
    scales it by the overdraw colour). Forward only. ``binned`` must use
    the "overdraw" field variant."""
    _check_inputs(binned.fields, binned.tile_starts, ty, tx, "overdraw")
    if binned.fields.is_cuda:
        return kernels.overdraw(binned.fields, binned.tile_starts,
                                height=height, ty=ty, tx=tx)
    return overdraw_plain(binned.fields, binned.tile_starts, height, ty, tx)
