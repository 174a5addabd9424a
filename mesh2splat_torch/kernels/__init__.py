"""Wrappers of the hand-written CUDA kernels (sources in ``csrc/``).

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on PyTorch's current stream, raises if
the launch reports an error, and adds one to its entry of ``launches``. The
callers in ``ops/`` and ``render/`` reach these only for CUDA tensors; CPU
tensors take the plain PyTorch versions beside them.

  texel_rows        K1  ops/fragment.py::texel_rows
  fragment_apply    K2  ops/fragment.py::fragment_apply
  composite_full    K3  render/composite.py::composite_tiles
  composite_albedo  K3  the same, albedo_only=True
  composite_bwd_full    K4  the backward of composite_tiles
  composite_bwd_albedo  K4  the same, albedo_only=True
"""

from __future__ import annotations

import ctypes

import torch

from . import build as _build

launches = {"texel_rows": 0, "fragment_apply": 0, "composite_full": 0,
            "composite_albedo": 0, "composite_bwd_full": 0,
            "composite_bwd_albedo": 0}

REC_W = 64
MAX_LEVELS = 8


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
                 [_P, _L, _P, _P, _L, _I, _Geom, _I, _I, _I, _I, _I, _P, _P]),
    "composite": ("m2s_composite_forward",
                  [_P, _L, _P, _I, _I, _I, _I, _P, _P, _P]),
    "composite_bwd": ("m2s_composite_backward",
                      [_P, _L, _P, _I, _I, _I, _I, _P, _P, _P, _P]),
}
_fns: dict = {}


def _fn(source: str):
    fn = _fns.get(source)
    if fn is None:
        sym, argtypes = _SIGNATURES[source]
        fn = getattr(_build.load(source), sym)
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


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err} "
                           f"({torch.cuda.get_device_name()})")


def texel_rows(records, metaT, *, res, geom, k, n_rows):
    """K1: (cap,) int32 packed atlas rows. records (REC_W, T_pad) f32,
    metaT (4, cap) f32 [tri, row_local, local, live]."""
    _check(records, "records", torch.float32, 2, rows=REC_W)
    _check(metaT, "metaT", torch.float32, 2, records.device, rows=4)
    cap = metaT.shape[1]
    out = torch.empty((cap,), dtype=torch.int32, device=records.device)
    err = _fn("texel_rows")(
        records.data_ptr(), records.shape[1], metaT.data_ptr(), cap, res,
        _geom(geom), k, n_rows, out.data_ptr(), _stream(records.device))
    _raise_on(err, "texel_rows")
    launches["texel_rows"] += 1
    return out


def fragment_apply(records, tapsT, metaT, *, res, geom, k, has_base,
                   has_normal, has_mr, taps_packed):
    """K2 forward: (OUT_W=20, cap) f32 splat rows. tapsT is (k*40, cap) f32,
    (k*20, cap) int32 bf16 pairs when taps_packed, or ignored when the
    material has no texture."""
    _check(records, "records", torch.float32, 2, rows=REC_W)
    _check(metaT, "metaT", torch.float32, 2, records.device, rows=4)
    cap = metaT.shape[1]
    has_stack = has_base or has_normal or has_mr
    if has_stack:
        rows = k * 4 * 10 // (2 if taps_packed else 1)
        _check(tapsT, "tapsT", torch.int32 if taps_packed else torch.float32,
               2, records.device, rows=rows)
        if tapsT.shape[1] != cap:
            raise ValueError(f"tapsT has {tapsT.shape[1]} slots, metaT {cap}")
    out = torch.empty((20, cap), dtype=torch.float32, device=records.device)
    err = _fn("fragment")(
        records.data_ptr(), records.shape[1],
        tapsT.data_ptr() if has_stack else None, metaT.data_ptr(), cap, res,
        _geom(geom), k, int(has_base), int(has_normal), int(has_mr),
        int(taps_packed), out.data_ptr(), _stream(records.device))
    _raise_on(err, "fragment_apply")
    launches["fragment_apply"] += 1
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


def composite_backward(fields, tile_starts, ct, res, *, height, ty, tx,
                       albedo_only):
    """K4: dfields (F_pad, P) f32, the VJP of composite_forward. ct is the
    (16, ty*32, tx*32) cotangent of its output, res the (2, ty*32, tx*32)
    per-pixel totals res_a, res_g (render/composite.py backward_totals).
    Rows outside every tile's range come back zero."""
    _check(fields, "fields", torch.float32, 2, rows=16 if albedo_only else 24)
    dev = fields.device
    _check(tile_starts, "tile_starts", torch.int32, 1, dev, rows=ty * tx + 1)
    img = (ty * 32, tx * 32)
    _check(ct, "ct", torch.float32, 3, dev, rows=16)
    _check(res, "res", torch.float32, 3, dev, rows=2)
    for t, name in ((ct, "ct"), (res, "res")):
        if tuple(t.shape[1:]) != img:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"(*, {img[0]}, {img[1]})")
    dfields = torch.zeros_like(fields)
    err = _fn("composite_bwd")(
        fields.data_ptr(), fields.shape[1], tile_starts.data_ptr(), ty, tx,
        height, int(albedo_only), ct.data_ptr(), res.data_ptr(),
        dfields.data_ptr(), _stream(dev))
    _raise_on(err, "composite_backward")
    launches["composite_bwd_albedo" if albedo_only else
             "composite_bwd_full"] += 1
    return dfields
