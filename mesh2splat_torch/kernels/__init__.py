"""Wrappers of the hand-written CUDA kernels (sources in ``csrc/``).

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on PyTorch's current stream, raises if
the launch reports an error, and adds one to its entry of ``launches``. The
callers in ``ops/`` and ``render/`` reach these only for CUDA tensors; CPU
tensors take the plain PyTorch versions beside them.

  texel_rows        K1  ops/fragment.py::texel_rows
  fragment_apply    K2  ops/fragment.py::fragment_apply
  fragment_apply_local  K2  the same, local_in_kernel=True
  composite_full    K3  render/composite.py::composite_tiles
  composite_albedo  K3  the same, albedo_only=True
  composite_bwd_full    K4  the backward of composite_tiles (main pass)
  composite_bwd_albedo  K4  the same, albedo_only=True
  composite_bwd_state_full    K4  its state pass (composite_bwd_states)
  composite_bwd_state_albedo  K4  the same, albedo_only=True
  min_depth         K5  render/composite.py::min_depth_tiles
  overdraw          K6  render/composite.py::overdraw_tiles
"""

from __future__ import annotations

import ctypes

import torch

from . import build as _build

launches = {"texel_rows": 0, "fragment_apply": 0, "fragment_apply_local": 0,
            "composite_full": 0, "composite_albedo": 0,
            "composite_bwd_full": 0, "composite_bwd_albedo": 0,
            "composite_bwd_state_full": 0, "composite_bwd_state_albedo": 0,
            "min_depth": 0, "overdraw": 0}

REC_W = 64
MAX_LEVELS = 8
CHUNK = 128       # pairs per chunk of a tile's walk (render/binning.py)
MIN_DEPTH_NONE = 3e38   # K5's value of a pixel no pair covers


def reset_launches():
    for name in launches:
        launches[name] = 0


class _Geom(ctypes.Structure):
    """Mirror of M2SGeom in csrc/slot_common.cuh."""

    _fields_ = [("levels", ctypes.c_int32), ("h0", ctypes.c_int32),
                ("w0", ctypes.c_int32),
                ("off", ctypes.c_int32 * MAX_LEVELS),
                ("hw_pad", ctypes.c_int32 * MAX_LEVELS)]


def _geom(geom) -> _Geom:
    if not 1 <= len(geom) <= MAX_LEVELS:
        raise ValueError(f"{len(geom)} mip levels: 1..{MAX_LEVELS} supported")
    g = _Geom(levels=len(geom), h0=geom[0][1], w0=geom[0][2])
    for i, (off, _, _, hw_pad) in enumerate(geom):
        g.off[i] = off
        g.hw_pad[i] = hw_pad
    return g


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_SIGNATURES = {
    "texel_rows": ("m2s_texel_rows",
                   [_P, _L, _P, _L, _I, _Geom, _I, _I, _P, _P]),
    "fragment": ("m2s_fragment_apply",
                 [_P, _L, _P, _P, _L, _I, _I, _P, _L, _I, _Geom, _I, _I, _I,
                  _I, _I, _I, _P, _P]),
    "composite": ("m2s_composite_forward",
                  [_P, _L, _P, _I, _I, _I, _I, _P, _P, _P]),
    "composite_bwd": ("m2s_composite_backward",
                      [_P, _L, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                       _P]),
    "composite_bwd_states": ("m2s_composite_bwd_states",
                             [_P, _L, _P, _P, _I, _I, _I, _I, _I, _P, _P,
                              _P]),
    "composite_bwd_seg_chunks": ("m2s_composite_bwd_seg_chunks", []),
    "single_channel": ("m2s_single_channel",
                       [_P, _L, _P, _P, _I, _I, _I, _I, _I, _P, _P]),
    "single_channel_seg_chunks": ("m2s_single_channel_seg_chunks", []),
    "single_channel_occupancy": ("m2s_single_channel_occupancy", [_I, _P]),
    "composite_occupancy": ("m2s_composite_forward_occupancy", [_I, _P]),
    "composite_bwd_occupancy": ("m2s_composite_backward_occupancy",
                                [_I, _I, _P]),
}
# the source that holds each symbol of _SIGNATURES
_SOURCE = {"composite_occupancy": "composite",
           "composite_bwd_states": "composite_bwd",
           "composite_bwd_seg_chunks": "composite_bwd",
           "composite_bwd_occupancy": "composite_bwd",
           "single_channel_seg_chunks": "single_channel",
           "single_channel_occupancy": "single_channel"}
_fns: dict = {}


def _fn(source: str):
    fn = _fns.get(source)
    if fn is None:
        sym, argtypes = _SIGNATURES[source]
        fn = getattr(_build.load(_SOURCE.get(source, source)), sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[source] = fn
    return fn


def _check(t, name, dtype, ndim, device=None, rows=None):
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim or (rows is not None and t.shape[0] != rows):
        raise ValueError(f"{name}: shape {tuple(t.shape)} is not "
                         f"({rows if rows is not None else '*'}, ...) "
                         f"with {ndim} dims")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_aligned(t, name):
    # K3-K6 stage a chunk's field rows whole, in 16-byte cp.async pieces:
    # every row must start on a 16-byte boundary and hold whole chunks
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")
    if t.shape[1] % CHUNK:
        raise ValueError(f"{name}: {t.shape[1]} pairs, not a multiple of "
                         f"{CHUNK} (render/binning.py pads to it)")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err} "
                           f"({torch.cuda.get_device_name()})")


def texel_rows(records, metaT, *, res, geom, k, n_rows):
    """K1: (cap,) int32 packed atlas rows. records (REC_W, T_pad) f32,
    metaT (4, cap) f32 [tri, row_local, local, live], its (tri, row_local)
    never decreasing along the slots. Writes each slot's local (its index
    within its (tri, row_local) segment) into row 2 of metaT, which it does
    not read. k (texels an atlas row, fragment.pack_factor) must be a power
    of two: the kernel divides by it with a shift."""
    if k < 1 or k & (k - 1):
        raise ValueError(f"k = {k} is not a power of two")
    _check(records, "records", torch.float32, 2, rows=REC_W)
    _check(metaT, "metaT", torch.float32, 2, records.device, rows=4)
    cap = metaT.shape[1]
    if cap >= 1 << 30:
        raise ValueError(f"metaT: {cap} slots, K1 takes fewer than 2^30")
    out = torch.empty((cap,), dtype=torch.int32, device=records.device)
    err = _fn("texel_rows")(
        records.data_ptr(), records.shape[1], metaT.data_ptr(), cap, res,
        _geom(geom), int(k).bit_length() - 1, n_rows, out.data_ptr(),
        _stream(records.device))
    _raise_on(err, "texel_rows")
    launches["texel_rows"] += 1
    return out


def fragment_apply(records, tapsT, metaT, *, res, geom, k, has_base,
                   has_normal, has_mr, taps_packed, local_in_kernel=False,
                   rows=None):
    """K2 forward: (OUT_W=20, cap) f32 splat rows. tapsT holds the taps, one
    column a texel: k*40 f32 fields, or k*20 int32 bf16 pairs when
    taps_packed; it is ignored when the material has no texture. Without
    rows it is (F, cap), slot i's taps in column i (gathered by the
    caller); with rows, a (cap,) int32 tensor of columns in [0, n_cols)
    (K1's texel_rows), it is the tap atlas (F, n_cols) and slot i reads
    column rows[i], of it only its sub-texel's 40 fields. tapsT may be
    contiguous (field-major) or the transpose of a contiguous (n_cols, F)
    tensor (row-major, 16-byte aligned); the kernel reads either.
    local_in_kernel: compute each slot's local from metaT rows 0-1 (as K1
    does: the (tri, row_local) keys must never decrease along the slots),
    write it into row 2 of metaT, which is then not read, and use it.
    Fewer than 2^30 slots."""
    _check(records, "records", torch.float32, 2, rows=REC_W)
    _check(metaT, "metaT", torch.float32, 2, records.device, rows=4)
    cap = metaT.shape[1]
    if cap >= 1 << 30:
        raise ValueError(f"metaT: {cap} slots, K2 takes fewer than 2^30")
    has_stack = has_base or has_normal or has_mr
    ld, n_cols, row_major = 0, 0, False
    if has_stack:
        n_fields = k * 4 * 10 // (2 if taps_packed else 1)
        dtype = torch.int32 if taps_packed else torch.float32
        row_major = (tapsT.dim() == 2 and not tapsT.is_contiguous()
                     and tapsT.T.is_contiguous())
        _check(tapsT.T if row_major else tapsT, "tapsT", dtype, 2,
               records.device)
        if tapsT.shape[0] != n_fields:
            raise ValueError(f"tapsT: shape {tuple(tapsT.shape)} is not "
                             f"({n_fields}, ...)")
        if row_major and tapsT.data_ptr() % 16:
            raise ValueError("a row-major tapsT must start on a 16-byte "
                             "boundary")
        n_cols = tapsT.shape[1]
        ld = n_fields if row_major else n_cols
        if rows is None and n_cols != cap:
            raise ValueError(f"tapsT has {n_cols} slots, metaT {cap}")
        if rows is not None:
            _check(rows, "rows", torch.int32, 1, records.device, rows=cap)
            if n_cols >= 1 << 31:
                raise ValueError(f"tapsT: {n_cols} columns, K2 takes fewer "
                                 "than 2^31")
    out = torch.empty((20, cap), dtype=torch.float32, device=records.device)
    err = _fn("fragment")(
        records.data_ptr(), records.shape[1],
        tapsT.data_ptr() if has_stack else None,
        rows.data_ptr() if has_stack and rows is not None else None, ld,
        n_cols, int(row_major), metaT.data_ptr(), cap, res, _geom(geom), k,
        int(has_base), int(has_normal), int(has_mr), int(taps_packed),
        int(local_in_kernel), out.data_ptr(), _stream(records.device))
    _raise_on(err, "fragment_apply")
    launches["fragment_apply_local" if local_in_kernel
             else "fragment_apply"] += 1
    return out


def composite_forward(fields, tile_starts, *, height, ty, tx, albedo_only,
                      walked=None):
    """K3: the (16, ty*32, tx*32) G-buffer. fields (F_pad, P) f32,
    tile_starts (ty*tx + 1,) int32. ``walked``, if given, is a (ty*tx,)
    int32 tensor that receives the number of pairs each tile walked before
    its early exit."""
    _check(fields, "fields", torch.float32, 2, rows=16 if albedo_only else 24)
    _check(tile_starts, "tile_starts", torch.int32, 1, fields.device,
           rows=ty * tx + 1)
    _check_aligned(fields, "fields")
    if walked is not None:
        _check(walked, "walked", torch.int32, 1, fields.device, rows=ty * tx)
    out = torch.empty((16, ty * 32, tx * 32), dtype=torch.float32,
                      device=fields.device)
    err = _fn("composite")(
        fields.data_ptr(), fields.shape[1], tile_starts.data_ptr(), ty, tx,
        height, int(albedo_only), out.data_ptr(),
        walked.data_ptr() if walked is not None else None,
        _stream(fields.device))
    _raise_on(err, "composite_forward")
    launches["composite_albedo" if albedo_only else "composite_full"] += 1
    return out


def seg_chunks() -> int:
    """The chunks of one of K4's segments, a constant of its source."""
    return _fn("composite_bwd_seg_chunks")()


def segment_table(tile_starts, seg_chunks):
    """The segments of K4, K5 and K6: a tile of nc chunks is walked as
    ceil(nc / seg_chunks) segments of seg_chunks chunks (the last one
    shorter), one block each. Returns seg_first, (tiles + 1,) int32 on
    tile_starts' device: the number of segments before each tile. Works on
    any device."""
    ts = tile_starts.long()
    starts, ends = ts[:-1], ts[1:]
    aligned = torch.div(starts, CHUNK, rounding_mode="floor") * CHUNK
    nc = torch.where(ends > starts, torch.div(
        ends - aligned + CHUNK - 1, CHUNK, rounding_mode="floor"), 0)
    nseg = torch.div(nc + seg_chunks - 1, seg_chunks, rounding_mode="floor")
    return torch.cat([nseg.new_zeros(1), torch.cumsum(nseg, 0)]).to(
        torch.int32)


def segment_blocks(n_tiles, capacity, seg_chunks):
    """A bound on the segment count from shapes alone, so that the launch
    needs no read of seg_first: a tile of n pairs has at most n / 128 + 2
    chunks, and the tiles hold at most ``capacity`` pairs. Blocks past the
    last segment return at once."""
    return n_tiles + (capacity // CHUNK + 2 * n_tiles) // seg_chunks + 1


def _check_backward(fields, tile_starts, ct, ty, tx, albedo_only):
    _check(fields, "fields", torch.float32, 2, rows=16 if albedo_only else 24)
    _check_aligned(fields, "fields")
    dev = fields.device
    _check(tile_starts, "tile_starts", torch.int32, 1, dev, rows=ty * tx + 1)
    _check(ct, "ct", torch.float32, 3, dev, rows=16)
    if tuple(ct.shape[1:]) != (ty * 32, tx * 32):
        raise ValueError(f"ct: shape {tuple(ct.shape)}, expected "
                         f"(*, {ty * 32}, {tx * 32})")


def composite_bwd_states(fields, tile_starts, ct, *, height, ty, tx,
                         albedo_only):
    """K4's state pass: (states, seg_first). states is (blocks, 2 or 4,
    1024) f32: for block b, the segment seg_first[t] + k = b of tile t (of
    seg_chunks() chunks), per tile-local pixel its T_a, Bpref_a (and T_g,
    Bpref_g) after a walk of the segment alone from T = 1, Bpref = 0. Rows
    of a tile's last segment, and past the last segment, are not
    written."""
    _check_backward(fields, tile_starts, ct, ty, tx, albedo_only)
    dev = fields.device
    seg = seg_chunks()
    seg_first = segment_table(tile_starts, seg)
    blocks = segment_blocks(ty * tx, fields.shape[1], seg)
    states = torch.empty((blocks, 2 if albedo_only else 4, 1024),
                         dtype=torch.float32, device=dev)
    err = _fn("composite_bwd_states")(
        fields.data_ptr(), fields.shape[1], tile_starts.data_ptr(),
        seg_first.data_ptr(), blocks, ty, tx, height,
        int(albedo_only), ct.data_ptr(), states.data_ptr(), _stream(dev))
    _raise_on(err, "composite_bwd_states")
    launches["composite_bwd_state_albedo" if albedo_only else
             "composite_bwd_state_full"] += 1
    return states, seg_first


def composite_backward(fields, tile_starts, ct, res, *, height, ty, tx,
                       albedo_only):
    """K4: dfields (F_pad, P) f32, the VJP of composite_forward. ct is the
    (16, ty*32, tx*32) cotangent of its output, res the (2, ty*32, tx*32)
    per-pixel totals res_a, res_g (render/composite.py backward_totals).
    Rows outside every tile's range come back zero. Launches the state pass
    (composite_bwd_states) and then the main pass over the segments of
    seg_chunks() chunks."""
    _check_backward(fields, tile_starts, ct, ty, tx, albedo_only)
    dev = fields.device
    _check(res, "res", torch.float32, 3, dev, rows=2)
    if tuple(res.shape[1:]) != (ty * 32, tx * 32):
        raise ValueError(f"res: shape {tuple(res.shape)}, expected "
                         f"(*, {ty * 32}, {tx * 32})")
    states, seg_first = composite_bwd_states(
        fields, tile_starts, ct, height=height, ty=ty, tx=tx,
        albedo_only=albedo_only)
    dfields = torch.zeros_like(fields)
    err = _fn("composite_bwd")(
        fields.data_ptr(), fields.shape[1], tile_starts.data_ptr(),
        seg_first.data_ptr(), states.shape[0], ty, tx, height,
        int(albedo_only), ct.data_ptr(), res.data_ptr(), states.data_ptr(),
        dfields.data_ptr(), _stream(dev))
    _raise_on(err, "composite_backward")
    launches["composite_bwd_albedo" if albedo_only else
             "composite_bwd_full"] += 1
    return dfields


def resident_blocks(name: str) -> int:
    """Blocks of 256 threads of kernel ``name`` (composite_full / _albedo,
    composite_bwd_full / _albedo, composite_bwd_state_full / _albedo,
    min_depth, overdraw) resident on one SM, from the CUDA occupancy
    calculator."""
    blocks = ctypes.c_int(0)
    albedo = int(name.endswith("albedo"))
    if name in ("min_depth", "overdraw"):
        err = _fn("single_channel_occupancy")(int(name == "min_depth"),
                                              ctypes.byref(blocks))
    elif name.startswith("composite_bwd"):
        err = _fn("composite_bwd_occupancy")(
            albedo, int("_state_" in name), ctypes.byref(blocks))
    else:
        err = _fn("composite_occupancy")(albedo, ctypes.byref(blocks))
    _raise_on(err, f"occupancy of {name}")
    return blocks.value


def single_channel_seg_chunks() -> int:
    """The chunks of one of K5's and K6's segments, a constant of their
    source."""
    return _fn("single_channel_seg_chunks")()


def _single_channel(fields, tile_starts, height, ty, tx, min_depth):
    # one block per segment of single_channel_seg_chunks() chunks; each
    # combines its pixels' partial min or count into the filled output
    _check(fields, "fields", torch.float32, 2, rows=8)
    _check(tile_starts, "tile_starts", torch.int32, 1, fields.device,
           rows=ty * tx + 1)
    _check_aligned(fields, "fields")
    seg = single_channel_seg_chunks()
    seg_first = segment_table(tile_starts, seg)
    blocks = segment_blocks(ty * tx, fields.shape[1], seg)
    out = torch.full((1, ty * 32, tx * 32),
                     MIN_DEPTH_NONE if min_depth else 0.0,
                     dtype=torch.float32, device=fields.device)
    err = _fn("single_channel")(
        fields.data_ptr(), fields.shape[1], tile_starts.data_ptr(),
        seg_first.data_ptr(), blocks, ty, tx, height, int(min_depth),
        out.data_ptr(), _stream(fields.device))
    name = "min_depth" if min_depth else "overdraw"
    _raise_on(err, name)
    launches[name] += 1
    return out


def min_depth(fields, tile_starts, *, height, ty, tx):
    """K5: the (1, ty*32, tx*32) per-pixel minimum depth over covering pairs
    (3e38 where none). fields (8, P) f32 of the "depth" variant, tile_starts
    (ty*tx + 1,) int32."""
    return _single_channel(fields, tile_starts, height, ty, tx, True)


def overdraw(fields, tile_starts, *, height, ty, tx):
    """K6: the (1, ty*32, tx*32) per-pixel count of covering pairs, as f32.
    fields (8, P) f32 of the "overdraw" variant, tile_starts (ty*tx + 1,)
    int32."""
    return _single_channel(fields, tile_starts, height, ty, tx, False)
