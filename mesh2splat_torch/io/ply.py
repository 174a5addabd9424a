"""Binary PLY codecs, byte-compatible with the reference's three formats
(counterpart of ``mesh2splat_tpu.io.ply``: the C++ codec of ``io/native.py``
by default, the numpy writers and reader otherwise; ``arrays_to_splats``
returns torch tensors).

Formats (reference: src/parsers/parsers.cpp:631-651 ``savePlyVector``):
  0 = standard 3DGS (62 float props incl. 45 zero f_rest_*)   parsers.cpp:431-514
  1 = PBR PLY (+ metallicFactor/roughnessFactor)              parsers.cpp:232-316
  2 = compressed PBR (u8 color/opacity, octa u8 normal)       parsers.cpp:339-428

Encoding conventions applied at write time (and inverted at read time):
  * color rgb -> SH0 via (c - 0.5)/SH_C0                      parsers.cpp:281,481
  * opacity  -> invSigmoid(clamp(a,0,1) + 1e-8)               parsers.cpp:299,494
  * scale    -> log(scale * scale_multiplier)                 parsers.cpp:302,497
    where scale_multiplier = gaussian_std / resolution_target (SceneManager.cpp:668)
  * rotation written as (w, x, y, z) into rot_0..rot_3        parsers.cpp:310-313

Implementation is vectorized numpy (structured arrays), not a per-vertex loop:
writing 7M standard-format splats is a single ~1.7 GB buffer assembly.
"""

from __future__ import annotations

import io
import numpy as np

SH_C0 = 0.28209479177387814


def _inv_sigmoid(a: np.ndarray) -> np.ndarray:
    """Float32 arithmetic like the reference (utils.hpp:270): at a == 1.0 the
    f32 result is +inf (sigmoid(+inf) == 1 on re-import), whereas f64 would
    produce NaN via log of a negative."""
    a = np.clip(a, 0.0, 1.0).astype(np.float32)
    with np.errstate(divide="ignore"):
        return -np.log(np.float32(1.0) / (a + np.float32(1e-8)) - np.float32(1.0))


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def _oct_encode(n: np.ndarray) -> np.ndarray:
    """(N,3) -> (N,2) in [0,1] (reference: parsers.cpp:320-337). Uses the
    standard per-component sign instead of the reference's non-invertible
    joint sign — see types.oct_encode docstring for the rationale."""
    denom = np.abs(n[:, 0]) + np.abs(n[:, 1]) + np.abs(n[:, 2]) + 1e-8
    nn = n / denom[:, None]
    sign = np.where(nn[:, :2] >= 0, 1.0, -1.0)
    wrapped = (1.0 - np.abs(nn[:, [1, 0]])) * sign
    res = np.where(nn[:, 2:3] >= 0.0, nn[:, :2], wrapped)
    return res * 0.5 + 0.5


def _header(num: int, props: list[str]) -> bytes:
    lines = ["ply", "format binary_little_endian 1.0", f"element vertex {num}"]
    lines += [f"property {p}" for p in props]
    lines.append("end_header")
    return ("\n".join(lines) + "\n").encode("ascii")


def _host(v):
    if hasattr(v, "detach"):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _as_np(splats_dict):
    return {k: _host(v) for k, v in splats_dict.items()}


def splats_to_arrays(splats) -> dict:
    """Extract live (valid) splats to host numpy arrays (one device -> host
    copy per field)."""
    idx = np.nonzero(_host(splats.valid))[0]
    return {
        name: _host(getattr(splats, name))[idx]
        for name in ("pos", "color", "scale", "normal", "quat", "pbr")
    }


STANDARD_PROPS = (
    ["float x", "float y", "float z", "float nx", "float ny", "float nz",
     "float f_dc_0", "float f_dc_1", "float f_dc_2"]
    + [f"float f_rest_{i}" for i in range(45)]
    + ["float opacity", "float scale_0", "float scale_1", "float scale_2",
       "float rot_0", "float rot_1", "float rot_2", "float rot_3"]
)

PBR_PROPS = [
    "float x", "float y", "float z", "float nx", "float ny", "float nz",
    "float f_dc_0", "float f_dc_1", "float f_dc_2",
    "float metallicFactor", "float roughnessFactor", "float opacity",
    "float scale_0", "float scale_1", "float scale_2",
    "float rot_0", "float rot_1", "float rot_2", "float rot_3",
]

COMPRESSED_PROPS = [
    "float x", "float y", "float z",
    "uint8 red", "uint8 green", "uint8 blue", "uint8 opacity",
    "float rot_0", "float rot_1", "float rot_2", "float rot_3",
    "float scale_0", "float scale_1", "float scale_2",
    "uint8 octa_nx", "uint8 octa_ny",
    "uint8 roughness", "uint8 metallic",
]


def write_ply_standard(arrs: dict, scale_multiplier: float) -> bytes:
    """Format 0 (reference: parsers.cpp:431-514)."""
    a = _as_np(arrs)
    n = a["pos"].shape[0]
    rec = np.zeros((n, 62), dtype="<f4")
    rec[:, 0:3] = a["pos"][:, :3]
    rec[:, 3:6] = a["normal"][:, :3]
    rec[:, 6:9] = (a["color"][:, :3] - 0.5) / SH_C0
    # 9..53 = f_rest zeros
    rec[:, 54] = _inv_sigmoid(a["color"][:, 3])
    with np.errstate(divide="ignore"):
        rec[:, 55:58] = np.log(a["scale"][:, :3] * scale_multiplier)
    rec[:, 58:62] = a["quat"]  # already (w,x,y,z) = rot_0..rot_3
    return _header(n, STANDARD_PROPS) + rec.tobytes()


def write_ply_pbr(arrs: dict, scale_multiplier: float) -> bytes:
    """Format 1 (reference: parsers.cpp:232-316)."""
    a = _as_np(arrs)
    n = a["pos"].shape[0]
    rec = np.zeros((n, 19), dtype="<f4")
    rec[:, 0:3] = a["pos"][:, :3]
    rec[:, 3:6] = a["normal"][:, :3]
    rec[:, 6:9] = (a["color"][:, :3] - 0.5) / SH_C0
    rec[:, 9] = a["pbr"][:, 0]   # metallicFactor
    rec[:, 10] = a["pbr"][:, 1]  # roughnessFactor
    rec[:, 11] = _inv_sigmoid(a["color"][:, 3])
    with np.errstate(divide="ignore"):
        rec[:, 12:15] = np.log(a["scale"][:, :3] * scale_multiplier)
    rec[:, 15:19] = a["quat"]
    return _header(n, PBR_PROPS) + rec.tobytes()


def write_ply_compressed(arrs: dict, scale_multiplier: float) -> bytes:
    """Format 2 (reference: parsers.cpp:339-428). Note the reference writes
    scale_2 = log(min(scale_x, scale_y) * mult) (parsers.cpp:403-406)."""
    a = _as_np(arrs)
    n = a["pos"].shape[0]

    def to_byte(v):
        return np.round(np.clip(v, 0.0, 1.0) * 255.0).astype(np.uint8)

    dt = np.dtype(
        [("pos", "<f4", 3), ("rgba", "u1", 4), ("rot", "<f4", 4),
         ("scale", "<f4", 3), ("octa", "u1", 2), ("rm", "u1", 2)]
    )
    rec = np.zeros(n, dtype=dt)
    rec["pos"] = a["pos"][:, :3]
    rec["rgba"] = to_byte(a["color"])
    rec["rot"] = a["quat"]
    sx, sy = a["scale"][:, 0], a["scale"][:, 1]
    with np.errstate(divide="ignore"):
        rec["scale"][:, 0] = np.log(sx * scale_multiplier)
        rec["scale"][:, 1] = np.log(sy * scale_multiplier)
        rec["scale"][:, 2] = np.log(np.minimum(sx, sy) * scale_multiplier)
    rec["octa"] = to_byte(_oct_encode(a["normal"][:, :3]))
    rec["rm"][:, 0] = to_byte(a["pbr"][:, 1])  # roughness first (parsers.cpp:420-424)
    rec["rm"][:, 1] = to_byte(a["pbr"][:, 0])  # then metallic
    return _header(n, COMPRESSED_PROPS) + rec.tobytes()


_FMT_PROPS = {0: STANDARD_PROPS, 1: PBR_PROPS, 2: COMPRESSED_PROPS}


def write_ply(path_or_buf, arrs: dict, fmt: int = 0, scale_multiplier: float = 1.0,
              use_native: bool = True):
    """Dispatch like savePlyVector (reference: parsers.cpp:631-651). The C++
    codec (io/native.py) writes the body when it is available and
    ``use_native``; the numpy writers otherwise. The two differ by up to 2
    ulp in the log and inverse-sigmoid columns (libm against numpy)."""
    data = None
    if use_native and fmt in _FMT_PROPS:
        from . import native

        a = _as_np(arrs)
        body = native.encode(fmt, a, scale_multiplier)
        if body is not None:
            data = _header(a["pos"].shape[0], _FMT_PROPS[fmt]) + body
    if data is None:
        writer = {
            0: write_ply_standard, 1: write_ply_pbr, 2: write_ply_compressed
        }.get(fmt, write_ply_standard)
        data = writer(arrs, scale_multiplier)
    if hasattr(path_or_buf, "write"):
        path_or_buf.write(data)
    else:
        with open(path_or_buf, "wb") as f:
            f.write(data)
    return len(data)


# ----------------------------------------------------------------------------
# Reader
# ----------------------------------------------------------------------------

_PLY_DTYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "ushort": "<u2", "uint16": "<u2", "short": "<i2", "int16": "<i2",
    "uint": "<u4", "uint32": "<u4", "int": "<i4", "int32": "<i4",
}


def _parse_ply_header(f) -> tuple[int, list[tuple[str, str]], int, bool]:
    """Returns (num_vertices, [(name, np_dtype)], data_offset, is_ascii)."""
    magic = f.readline().strip()
    if magic != b"ply":
        raise ValueError("not a PLY file")
    num = None
    props: list[tuple[str, str]] = []
    in_vertex = False
    is_ascii = False
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unexpected EOF in PLY header")
        parts = line.strip().decode("ascii", "replace").split()
        if not parts:
            continue
        if parts[0] == "format":
            # the reference reads via happly, which accepts ascii and binary
            # little-endian alike (parsers.cpp:519 happly::PLYData)
            if parts[1] == "ascii":
                is_ascii = True
            elif parts[1] != "binary_little_endian":
                raise ValueError(f"unsupported PLY format {parts[1]}")
        elif parts[0] == "element":
            in_vertex = parts[1] == "vertex"
            if in_vertex:
                num = int(parts[2])
        elif parts[0] == "property" and in_vertex:
            props.append((parts[2], _PLY_DTYPES[parts[1]]))
        elif parts[0] == "end_header":
            break
    return num, props, f.tell(), is_ascii


def _finite_filter(arrs: dict) -> dict:
    """Drop splats with any non-finite field or an all-zero record —
    utils::shouldSkip parity (reference: utils.cpp:386-402)."""
    finite = np.ones(arrs["pos"].shape[0], bool)
    nonzero = np.zeros(arrs["pos"].shape[0], bool)
    for a in arrs.values():
        finite &= np.isfinite(a).all(axis=-1)
        nonzero |= (a != 0.0).any(axis=-1)
    keep = finite & nonzero
    if keep.all():
        return arrs
    return {k: v[keep] for k, v in arrs.items()}


def read_ply(path, filter_invalid: bool = True) -> tuple[dict, bool]:
    """Read any of the three formats (plus generic 3DGS PLYs) into the
    canonical splat dict, mirroring loadPlyFile (reference: parsers.cpp:516-629):
      opacity -> sigmoid, scale -> exp, rot -> normalized, stored (w,x,y,z),
      color <- SH0.  Returns (arrays, has_pbr). ``filter_invalid`` applies the
    utils::shouldSkip NaN/Inf/all-zero filter (reference: utils.cpp:386-402)."""
    with open(path, "rb") as f:
        num, props, off, is_ascii = _parse_ply_header(f)
        dt = np.dtype([(name, d) for name, d in props])
        if is_ascii:
            body = np.loadtxt(f, dtype=np.float64, max_rows=num, ndmin=2)
            if body.shape != (num, len(props)):
                raise ValueError(
                    f"truncated ASCII PLY: header promises {num}x{len(props)},"
                    f" file contains {body.shape}"
                )
            raw = np.empty(num, dtype=dt)
            for i, (name, d) in enumerate(props):
                raw[name] = body[:, i].astype(d)
        else:
            raw = np.fromfile(f, dtype=dt, count=num)
            if raw.shape[0] != num:
                raise ValueError(
                    f"truncated PLY: header promises {num} vertices, "
                    f"file contains {raw.shape[0]}"
                )

    names = {name for name, _ in props}

    # float-only binary layouts (formats 0/1 and generic 3DGS) decode through
    # the native codec when it is available
    if (
        not is_ascii
        and "red" not in names
        and {"x", "f_dc_0", "opacity", "scale_0", "rot_0"} <= names
        and all(d == "<f4" for _, d in props)
    ):
        from . import native

        col = {name: i for i, (name, _) in enumerate(props)}
        have_n = {"nx", "ny", "nz"} <= names
        have_pbr = {"metallicFactor", "roughnessFactor"} <= names
        dec = native.decode_float_body(
            num,
            len(props),
            {
                "xyz": col["x"],
                "normal": col["nx"] if have_n else -1,
                "fdc": col["f_dc_0"],
                "opacity": col["opacity"],
                "scale": col["scale_0"],
                "rot": col["rot_0"],
                "metal": col["metallicFactor"] if have_pbr else -1,
                "rough": col["roughnessFactor"] if have_pbr else -1,
            },
            raw.view("<f4").reshape(num, len(props)),
        )
        if dec is not None:
            if filter_invalid:
                dec = _finite_filter(dec)
            return dec, have_n and have_pbr

    def get(name, default=None):
        if name in names:
            return raw[name].astype(np.float32)
        return default

    pos = np.stack([get("x"), get("y"), get("z")], axis=-1)
    compressed = "red" in names  # format 2

    if compressed:
        rgb = np.stack([get("red"), get("green"), get("blue")], axis=-1) / 255.0
        opacity = get("opacity") / 255.0
        color = np.concatenate([rgb, opacity[:, None]], axis=-1)
        nx_ny = np.stack([get("octa_nx"), get("octa_ny")], axis=-1) / 255.0
        f2 = nx_ny * 2.0 - 1.0
        nz = 1.0 - np.abs(f2[:, 0]) - np.abs(f2[:, 1])
        t = np.clip(-nz, 0.0, 1.0)
        xy = f2 - np.where(f2 >= 0.0, t[:, None], -t[:, None])
        normal = np.concatenate([xy, nz[:, None]], axis=-1)
        normal /= np.linalg.norm(normal, axis=-1, keepdims=True) + 1e-12
        pbr = np.stack([get("metallic") / 255.0, get("roughness") / 255.0], axis=-1)
        has_pbr = True
    else:
        sh = np.stack([get("f_dc_0"), get("f_dc_1"), get("f_dc_2")], axis=-1)
        rgb = sh * SH_C0 + 0.5
        opacity = _sigmoid(get("opacity"))
        color = np.concatenate([rgb, opacity[:, None]], axis=-1)
        nxs, nys, nzs = get("nx"), get("ny"), get("nz")
        met, rough = get("metallicFactor"), get("roughnessFactor")
        has_pbr = all(v is not None for v in (nxs, nys, nzs, met, rough))
        if nxs is not None:
            normal = np.stack([nxs, nys, nzs], axis=-1)
        else:
            normal = np.zeros_like(pos)
        if has_pbr:
            pbr = np.stack([met, rough], axis=-1)
        else:
            pbr = np.zeros((num, 2), np.float32)

    scale = np.exp(np.stack([get("scale_0"), get("scale_1"), get("scale_2")], axis=-1))
    quat = np.stack([get("rot_0"), get("rot_1"), get("rot_2"), get("rot_3")], axis=-1)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True) + 1e-12

    arrs = {
        "pos": pos.astype(np.float32),
        "color": color.astype(np.float32),
        "scale": scale.astype(np.float32),
        "normal": normal.astype(np.float32),
        "quat": quat.astype(np.float32),
        "pbr": pbr.astype(np.float32),
    }
    if filter_invalid:
        arrs = _finite_filter(arrs)
    return arrs, has_pbr


def arrays_to_splats(arrs: dict, capacity: int | None = None, device="cuda"):
    """Host numpy arrays -> Splats on ``device`` (zero-padded to capacity)."""
    import torch

    from ..types import Splats, resolve_device

    dev = resolve_device(device)
    n = arrs["pos"].shape[0]
    cap = capacity or n

    def put(src):
        pad = np.zeros((cap - n,) + src.shape[1:], src.dtype)
        return torch.from_numpy(np.concatenate([src, pad], axis=0)).to(dev)

    return Splats(
        pos=put(arrs["pos"]), color=put(arrs["color"]),
        scale=put(arrs["scale"]), normal=put(arrs["normal"]),
        quat=put(arrs["quat"]), pbr=put(arrs["pbr"]),
        valid=torch.from_numpy(np.arange(cap) < n).to(dev),
    )
