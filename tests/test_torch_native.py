"""mesh2splat_torch's C++ host codec (io/native.py, io/csrc/) against the
JAX package's (mesh2splat_tpu/io/native.py): the same sources built with the
same flags give the same bytes; the port's default PLY writer equals the JAX
default writer byte for byte, and its numpy writer within
tests/test_native.py's 2-ulp rule; the decoders and the glTF assembly are
bit-equal; without the library the numpy paths run."""

import numpy as np
import pytest

from mesh2splat_tpu.io import gltf as JG
from mesh2splat_tpu.io import native as JN
from mesh2splat_tpu.io import ply as JPLY

from mesh2splat_torch.io import gltf as TG
from mesh2splat_torch.io import native as TN
from mesh2splat_torch.io import ply as TPLY
from test_ply import make_arrays

WRITERS = {0: TPLY.write_ply_standard, 1: TPLY.write_ply_pbr,
           2: TPLY.write_ply_compressed}


@pytest.fixture(scope="module")
def libs():
    if not (JN.available() and TN.available()):
        pytest.skip("native library unavailable (no toolchain)")
    return True


def test_builds_into_build_native(libs):
    path = TN.lib_path()
    assert path.exists()
    assert path.parent.name == "native" and path.parent.parent.name == "build"


@pytest.mark.parametrize("fmt", [0, 1, 2])
def test_encode_matches_jax_codec(libs, fmt):
    arrs = make_arrays(101, seed=fmt)
    arrs["color"][:3, 3] = 1.0      # opacity 1 encodes to +inf
    body = TN.encode(fmt, arrs, 0.25)
    assert body is not None and body == JN.encode(fmt, arrs, 0.25)


@pytest.mark.parametrize("fmt", [0, 1, 2])
def test_encode_against_numpy_writer(libs, fmt):
    """tests/test_native.py's rule on the port: the native body equals the
    numpy writer's except in the transcendental columns (log scales and the
    opacity inverse sigmoid), and there by at most 2 ulp."""
    n = 101
    arrs = make_arrays(n, seed=fmt)
    expected = WRITERS[fmt](arrs, 0.25)
    body = TN.encode(fmt, arrs, 0.25)
    got = TPLY._header(n, TPLY._FMT_PROPS[fmt]) + body
    assert len(got) == len(expected)
    if got == expected:
        return
    eb = expected.partition(b"end_header\n")[2]
    if fmt in (0, 1):
        stride = 62 if fmt == 0 else 19
        ulp_cols = {54, 55, 56, 57} if fmt == 0 else {11, 12, 13, 14}
        e = np.frombuffer(eb, "<f4").reshape(n, stride)
        g = np.frombuffer(body, "<f4").reshape(n, stride)
        bad = np.argwhere(e != g)
        assert set(bad[:, 1].tolist()) <= ulp_cols, bad
        assert np.abs(e.view(np.int32) - g.view(np.int32)).max() <= 2
    else:
        dt = np.dtype([("pos", "<f4", 3), ("rgba", "u1", 4), ("rot", "<f4", 4),
                       ("scale", "<f4", 3), ("octa", "u1", 2),
                       ("rm", "u1", 2)])
        e = np.frombuffer(eb, dtype=dt)
        g = np.frombuffer(body, dtype=dt)
        for f in ("pos", "rgba", "rot", "octa", "rm"):
            np.testing.assert_array_equal(e[f], g[f], err_msg=f)
        assert np.abs(e["scale"].view(np.int32)
                      - g["scale"].view(np.int32)).max() <= 2


@pytest.mark.parametrize("fmt", [0, 1, 2])
def test_write_ply_default_equals_jax_default(libs, fmt, tmp_path):
    arrs = make_arrays(257, seed=10 + fmt)
    a, b = tmp_path / "jax.ply", tmp_path / "port.ply"
    JPLY.write_ply(str(a), arrs, fmt=fmt, scale_multiplier=0.0039)
    TPLY.write_ply(str(b), arrs, fmt=fmt, scale_multiplier=0.0039)
    assert a.read_bytes() == b.read_bytes()


def test_decode_float_body_and_read_ply_match_jax(libs, tmp_path):
    """decode_float_body bit-equal to the JAX codec's on a format-1 body,
    and read_ply (which decodes float bodies through it) equal to the JAX
    read_ply for formats 0 and 1."""
    arrs = make_arrays(53, seed=3)
    p = tmp_path / "d.ply"
    TPLY.write_ply(p, arrs, fmt=1, scale_multiplier=1.0)
    with open(p, "rb") as f:
        num, props, _, _ = TPLY._parse_ply_header(f)
        body = np.fromfile(f, dtype="<f4").reshape(num, len(props))
    names = [n for n, _ in props]
    offsets = {"xyz": names.index("x"), "normal": names.index("nx"),
               "fdc": names.index("f_dc_0"),
               "opacity": names.index("opacity"),
               "scale": names.index("scale_0"), "rot": names.index("rot_0"),
               "metal": names.index("metallicFactor"),
               "rough": names.index("roughnessFactor")}
    got = TN.decode_float_body(num, len(props), offsets, body)
    ref = JN.decode_float_body(num, len(props), offsets, body)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for fmt in (0, 1):
        TPLY.write_ply(p, arrs, fmt=fmt, scale_multiplier=0.5)
        (ta, tp), (ja, jp) = TPLY.read_ply(p), JPLY.read_ply(p)
        assert tp == jp == (fmt == 1)
        for k in ja:
            np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)


def test_accessor_decode_matches_jax(libs):
    rng = np.random.default_rng(0)
    cases = [
        # interleaved u16-normalized UVs with stride 12
        (rng.integers(0, 65535, (7, 6), dtype=np.uint16).tobytes(),
         7, 2, 5123, 12, True),
        # f32 with stride 20
        (rng.standard_normal((5, 5)).astype(np.float32).tobytes(),
         5, 3, 5126, 20, False),
        # u8-normalized colours, packed
        (rng.integers(0, 255, (9, 4), dtype=np.uint8).tobytes(),
         9, 4, 5121, 4, True),
    ]
    for case in cases:
        got, ref = TN.accessor_decode(*case), JN.accessor_decode(*case)
        assert got is not None
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("attrs", ["all", "positions_uvs"])
def test_assemble_triangles_matches_jax(libs, attrs):
    """World-space assembly with a translated, rotated, scaled node, with
    every attribute or with the flat-normal and tangent fallbacks."""
    rng = np.random.default_rng(1)
    v = rng.uniform(-1, 1, (30, 3)).astype(np.float32)
    idx = rng.integers(0, 30, 60).astype(np.uint32)
    world = np.eye(4, dtype=np.float32)
    world[:3, :3] = np.diag([1.5, 0.5, 1.0]) @ np.asarray(
        [[0.8, -0.6, 0], [0.6, 0.8, 0], [0, 0, 1]], np.float32)
    world[:3, 3] = [0.5, -0.25, 2.0]
    nmat = np.linalg.inv(world[:3, :3]).T.astype(np.float32)
    uv = rng.uniform(0, 1, (30, 2)).astype(np.float32)
    nrm = tan = None
    if attrs == "all":
        nrm = rng.normal(size=(30, 3)).astype(np.float32)
        tan = np.concatenate([rng.normal(size=(30, 3)),
                              np.sign(rng.normal(size=(30, 1)))],
                             -1).astype(np.float32)
    got = TN.assemble_triangles(v, nrm, uv, tan, idx, world, nmat)
    ref = JN.assemble_triangles(v, nrm, uv, tan, idx, world, nmat)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_array_equal(g, r)


def test_numpy_paths_without_the_library(tmp_path, monkeypatch):
    """With no library (no toolchain) write_ply writes the numpy bytes and
    load_glb assembles with numpy, equal to the JAX numpy loader."""
    monkeypatch.setattr(TN, "_load", lambda: None)
    arrs = make_arrays(40, seed=7)
    a, b = tmp_path / "a.ply", tmp_path / "b.ply"
    TPLY.write_ply(a, arrs, fmt=1, scale_multiplier=0.5)
    JPLY.write_ply(b, arrs, fmt=1, scale_multiplier=0.5, use_native=False)
    assert a.read_bytes() == b.read_bytes()
    back, has_pbr = TPLY.read_ply(a)
    assert has_pbr and back["pos"].shape == (40, 3)
    v = np.asarray([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    idx = np.asarray([[0, 1, 2], [0, 2, 3]], np.uint32)
    glb = tmp_path / "q.glb"
    TG.write_glb(glb, v, idx, uvs=v[:, :2])
    monkeypatch.setattr(JN, "_load", lambda: None)
    got, ref = TG.load_glb(glb)[0], JG.load_glb(glb)[0]
    for f in ("tri_pos", "tri_normal", "tri_uv", "tri_tangent"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f),
                                      err_msg=f)
