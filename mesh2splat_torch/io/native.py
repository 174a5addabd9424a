"""ctypes bindings for the port's native host codec (counterpart of
``mesh2splat_tpu.io.native``): the PLY body encode/decode and the glTF
accessor decode and triangle assembly of ``io/csrc/``.

The library is built with make (g++) at first use into ``build/native/`` of
the checkout, under a name that carries the hash of the sources and of the
host CPU (the Makefile builds with ``-march=native``). Nothing is built when
the module is imported. Every entry point returns None when the library
cannot be built or loaded, and ``io/ply.py`` and ``io/gltf.py`` then take
their numpy paths, so the package works without a toolchain.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

import numpy as np

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "native"
SOURCES = ("ply_codec.cpp", "glb_decode.cpp", "Makefile")

_lock = threading.Lock()
_state: dict = {}   # "lib": the loaded CDLL or None once a load was tried


def _host_cpu() -> bytes:
    """The CPU's model and feature flags: a library built with
    -march=native on one CPU is not loaded on another."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = [ln for ln in f.read().splitlines()
                     if ln.startswith((b"model name", b"flags"))]
        return b"\n".join(sorted(set(lines)))
    except OSError:
        import platform

        return platform.processor().encode()


def lib_path() -> pathlib.Path:
    h = hashlib.sha256(_host_cpu())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libm2s_native_{h.hexdigest()[:16]}.so"


def _build(path: pathlib.Path):
    """make into a file of this process, then rename it into place, so that
    processes building at the same time never load a half-written file."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    try:
        subprocess.run(["make", "-s", "-B", f"OUT={tmp}"], cwd=CSRC,
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


def _declare(lib):
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    i32, i64 = ctypes.c_int, ctypes.c_longlong
    lib.m2s_record_size.restype = i32
    lib.m2s_record_size.argtypes = [i32]
    lib.m2s_encode.restype = i64
    lib.m2s_encode.argtypes = [i32, i64, ctypes.c_float] + [f32p] * 6 + [u8p]
    lib.m2s_decode_float_body.restype = i64
    lib.m2s_decode_float_body.argtypes = [i64] + [i32] * 9 + [f32p] * 7
    lib.m2s_accessor_decode.restype = i32
    lib.m2s_accessor_decode.argtypes = [ctypes.c_char_p, i64, i32, i32, i64,
                                        i32, f32p]
    lib.m2s_assemble_triangles.restype = None
    lib.m2s_assemble_triangles.argtypes = (
        [ctypes.c_void_p] * 4 + [u32p, i64] + [f32p] * 6)
    return lib


def _load():
    with _lock:
        if "lib" not in _state:
            try:
                path = lib_path()
                if not path.exists():
                    _build(path)
                _state["lib"] = _declare(ctypes.CDLL(str(path)))
            except (OSError, subprocess.SubprocessError):
                _state["lib"] = None
        return _state["lib"]


def available() -> bool:
    """Whether the library is built and loaded (building it if need be)."""
    return _load() is not None


def encode(fmt: int, arrs: dict, scale_multiplier: float) -> bytes | None:
    """The PLY body of format ``fmt`` (0-2) for numpy ``arrs``; None if the
    library is unavailable or does not know the format."""
    lib = _load()
    if lib is None:
        return None
    n = arrs["pos"].shape[0]
    rec = lib.m2s_record_size(fmt)
    if rec < 0:
        return None
    out = np.empty(n * rec, np.uint8)
    c = lambda a: np.ascontiguousarray(a, np.float32)  # noqa: E731
    written = lib.m2s_encode(
        fmt, n, float(scale_multiplier),
        c(arrs["pos"]), c(arrs["color"]), c(arrs["scale"]),
        c(arrs["normal"]), c(arrs["quat"]), c(arrs["pbr"]), out,
    )
    if written != n * rec:
        return None
    return out.tobytes()


def decode_float_body(n: int, stride_floats: int, offsets: dict,
                      body: np.ndarray) -> dict | None:
    """Decode a float-only PLY body (formats 0/1 and generic 3DGS) of ``n``
    records of ``stride_floats`` floats. ``offsets``: each field's first
    float, -1 where absent."""
    lib = _load()
    if lib is None:
        return None
    out = {k: np.empty((n, c), np.float32) for k, c in (
        ("pos", 3), ("color", 4), ("scale", 3), ("normal", 3), ("quat", 4),
        ("pbr", 2))}
    lib.m2s_decode_float_body(
        n, stride_floats,
        offsets["xyz"], offsets.get("normal", -1), offsets["fdc"],
        offsets["opacity"], offsets["scale"], offsets["rot"],
        offsets.get("metal", -1), offsets.get("rough", -1),
        np.ascontiguousarray(body, np.float32),
        out["pos"], out["color"], out["scale"], out["normal"], out["quat"],
        out["pbr"],
    )
    return out


def accessor_decode(raw: bytes, count: int, ncomp: int, component_type: int,
                    stride: int, normalized: bool) -> np.ndarray | None:
    """Strided glTF accessor decode to (count, ncomp) float32; None if the
    library is unavailable or rejects the component type."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((count, ncomp), np.float32)
    rc = lib.m2s_accessor_decode(raw, count, ncomp, component_type, stride,
                                 int(normalized), out)
    return out if rc == 0 else None


def assemble_triangles(pos, nrm, uv, tan, idx, world, normal_mat):
    """World-space triangle assembly with the reference's flat-normal and
    per-face tangent fallbacks: (tri_pos, tri_normal, tri_uv, tri_tangent)
    as (F, 3, 3/3/2/4) float32, or None if the library is unavailable.
    ``nrm``, ``uv`` and ``tan`` may be None."""
    lib = _load()
    if lib is None:
        return None
    f = int(idx.size // 3)
    tri_pos = np.empty((f, 3, 3), np.float32)
    tri_normal = np.empty((f, 3, 3), np.float32)
    tri_uv = np.empty((f, 3, 2), np.float32)
    tri_tangent = np.empty((f, 3, 4), np.float32)
    # the contiguous copies stay referenced until the call returns
    keep = [None if a is None else np.ascontiguousarray(a, np.float32)
            for a in (pos, nrm, uv, tan)]
    ptrs = [None if a is None else a.ctypes.data_as(ctypes.c_void_p)
            for a in keep]
    lib.m2s_assemble_triangles(
        *ptrs, np.ascontiguousarray(idx, np.uint32), f,
        np.ascontiguousarray(world, np.float32).reshape(-1),
        np.ascontiguousarray(normal_mat, np.float32).reshape(-1),
        tri_pos, tri_normal, tri_uv, tri_tangent,
    )
    return tri_pos, tri_normal, tri_uv, tri_tangent
