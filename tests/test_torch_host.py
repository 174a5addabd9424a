"""mesh2splat_torch's host utilities against the JAX package on the same
inputs (numpy, from seeds): the UV unwrap, the sampling layouts, the fly
camera, the frame timer and profiler helpers, and write_glb round trips
through both packages' load_glb."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mesh2splat_tpu.io import gltf as JG
from mesh2splat_tpu.ops import sampling as JS
from mesh2splat_tpu.ops.conversion import ConversionConfig as JCfg
from mesh2splat_tpu.ops.conversion import convert as j_convert
from mesh2splat_tpu.ops.uv_unwrap import unwrap_normalized_uvs as j_unwrap
from mesh2splat_tpu.types import Material as JMaterial
from mesh2splat_tpu.types import TriangleMesh as JMesh
from mesh2splat_tpu.utils import camera_controller as JCC
from mesh2splat_tpu.utils import profiling as JPROF

from mesh2splat_torch import state
from mesh2splat_torch.io import gltf as TG
from mesh2splat_torch.ops import sampling as TS
from mesh2splat_torch.ops.conversion import ConversionConfig
from mesh2splat_torch.ops.conversion import convert as t_convert
from mesh2splat_torch.ops.uv_unwrap import unwrap_normalized_uvs
from mesh2splat_torch.types import Material
from mesh2splat_torch.utils import camera_controller as TCC
from mesh2splat_torch.utils import profiling as TPROF

RNG_SEED = 0


def _charts_disjoint(uv, res=256):
    """test_triplanar.py's check: no texel centre inside two charts."""
    ii, jj = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    p = (np.stack([jj, ii], -1).reshape(-1, 2) + 0.5) / res
    hits = np.zeros(res * res, np.int32)
    for a, b, c in uv:
        d = (b[0] - a[0]) * (c[1] - a[1]) - (c[0] - a[0]) * (b[1] - a[1])
        if abs(d) < 1e-12:
            continue
        wb = ((p[:, 0] - a[0]) * (c[1] - a[1])
              - (c[0] - a[0]) * (p[:, 1] - a[1])) / d
        wc = ((b[0] - a[0]) * (p[:, 1] - a[1])
              - (p[:, 0] - a[0]) * (b[1] - a[1])) / d
        hits += ((1 - wb - wc > 1e-6) & (wb > 1e-6) & (wc > 1e-6))
    return hits.max() <= 1 and hits.sum() > 50


def test_unwrap_normalized_uvs_matches_jax():
    """Bit-equal charts, disjoint, and the conversion on them (ortho_uv)
    gives the JAX package's splat count and valid mask."""
    rng = np.random.default_rng(5)
    t = 30
    tri_pos = rng.uniform(0, 1, (t, 3, 3)).astype(np.float32)
    uv = unwrap_normalized_uvs(tri_pos)
    np.testing.assert_array_equal(uv, j_unwrap(tri_pos))
    assert uv.shape == (t, 3, 2) and uv.min() >= 0 and uv.max() <= 1 + 1e-6
    assert _charts_disjoint(uv)
    assert unwrap_normalized_uvs(np.zeros((0, 3, 3))).shape == (0, 3, 2)

    mesh = dict(
        tri_pos=tri_pos,
        tri_normal=np.broadcast_to([0, 0, 1.0], (t, 3, 3)).astype(np.float32),
        tri_tangent=np.broadcast_to([1, 0, 0, 1.0], (t, 3, 4))
        .astype(np.float32),
        tri_uv=tri_pos[..., :2].copy())
    jm = JMesh(**{k: jnp.asarray(v) for k, v in mesh.items()})
    js = j_convert(jm, JMaterial.default(), *jm.bbox(),
                   JCfg(resolution=64, layers=4), ortho_uv=jnp.asarray(uv))
    tm = state.mesh(mesh, "cpu")
    ts = t_convert(tm, Material.default("cpu"), *tm.bbox(),
                   ConversionConfig(resolution=64, layers=4),
                   ortho_uv=torch.from_numpy(uv))
    assert 0 < int(ts.count()) == int(js.count()) <= 64 * 64
    np.testing.assert_array_equal(ts.valid.numpy(), np.asarray(js.valid))


def _sample_inputs():
    rng = np.random.default_rng(RNG_SEED)
    tex = rng.uniform(0, 1, (32, 32, 4)).astype(np.float32)
    layers = rng.uniform(0, 1, (3, 16, 16, 4)).astype(np.float32)
    uv = rng.uniform(-0.2, 1.2, (2000, 2)).astype(np.float32)
    layer = rng.integers(0, 3, 2000).astype(np.int32)
    return tex, layers, uv, layer


SAMPLERS = {
    "bilinear": lambda m, tex, layers, uv, layer: m.sample_bilinear(tex, uv),
    "nearest": lambda m, tex, layers, uv, layer: m.sample_nearest(tex, uv),
    "tap_atlas": lambda m, tex, layers, uv, layer: m.sample_bilinear_atlas(
        m.build_tap_atlas(tex), 32, 32, 4, uv),
    "tap_atlas_layered": lambda m, tex, layers, uv, layer:
        m.sample_bilinear_atlas_layered(m.build_tap_atlas_layered(layers),
                                        16, 16, 4, uv, layer),
    "block_atlas": lambda m, tex, layers, uv, layer:
        m.sample_bilinear_block_atlas(m.build_block_atlas(tex), 32, 32, 4,
                                      uv),
}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_sampling_matches_jax(name):
    """Each sampler bit-equal to the JAX package's on the same inputs; the
    block atlas also bit-equal to direct bilinear sampling
    (tests/test_codecs.py::test_block_atlas_sampling_exact)."""
    arrays = _sample_inputs()
    got = SAMPLERS[name](TS, *map(torch.from_numpy, arrays)).numpy()
    ref = np.asarray(SAMPLERS[name](JS, *map(jnp.asarray, arrays)))
    np.testing.assert_array_equal(got, ref)
    if name == "block_atlas":
        direct = TS.sample_bilinear(*map(torch.from_numpy, arrays[::2]))
        np.testing.assert_array_equal(got, direct.numpy())


def test_atlases_match_jax():
    tex, layers, _, _ = _sample_inputs()
    for build, t in (("build_tap_atlas", tex),
                     ("build_tap_atlas_layered", layers),
                     ("build_block_atlas", tex)):
        np.testing.assert_array_equal(
            getattr(TS, build)(torch.from_numpy(t)).numpy(),
            np.asarray(getattr(JS, build)(jnp.asarray(t))), err_msg=build)
    with pytest.raises(ValueError, match="block"):
        TS.build_block_atlas(torch.zeros(6, 8, 4))


def test_fly_camera_matches_jax():
    """tests/test_pipeline.py::test_fly_camera_controller's moves, and more,
    on both packages: the same position, angles, basis and camera
    matrices after every move."""
    moves = [("move", dict(dt=1.0, forward=1.0)), ("look", (900, 0)),
             ("move", dict(dt=0.5, strafe=1.0, lift=-0.5, fast=True)),
             ("roll", (15.0,)), ("look", (-120, 45)),
             ("move", dict(dt=0.25, forward=-1.0, slow=True)),
             ("look", (0, 10000)), ("zoom", (1000,)), ("zoom", (-50,))]
    t, j = TCC.FlyCamera.create([0, 0, 3]), JCC.FlyCamera.create([0, 0, 3])
    for name, arg in moves:
        for cam in (t, j):
            fn = getattr(cam, name)
            fn(**arg) if isinstance(arg, dict) else fn(*arg)
        np.testing.assert_array_equal(t.position, j.position)
        assert (t.yaw_deg, t.pitch_deg, t.roll_deg, t.fov_deg) == \
            (j.yaw_deg, j.pitch_deg, j.roll_deg, j.fov_deg)
        for a, b in zip(t.basis(), j.basis()):
            np.testing.assert_array_equal(a, b)
        tc, jc = t.camera(64, 48, device="cpu"), j.camera(64, 48)
        assert (tc.width, tc.height) == (64, 48)
        np.testing.assert_array_equal(tc.world_to_view.numpy(),
                                      np.asarray(jc.world_to_view))
        np.testing.assert_array_equal(tc.view_to_clip.numpy(),
                                      np.asarray(jc.view_to_clip))
    assert t.pitch_deg == -89.0 and t.fov_deg == 51.0


def test_frame_timer_pool_and_latency():
    """The JAX FrameTimer's semantics on the CPU: None until ``latency``
    frames are pending, then one sample a frame, at most ``pool`` kept;
    the same on both packages for the same frames."""
    t = TPROF.FrameTimer(pool=4, latency=2)
    j = JPROF.FrameTimer(pool=4, latency=2)
    for i in range(7):
        got = t.frame(torch.full((2,), float(i)))
        ref = j.frame(jnp.full((2,), float(i)))
        assert (got is None) == (ref is None) == (i < 2)
        assert len(t.samples) == len(j.samples) == min(max(i - 1, 0), 4)
    assert t.frame({"img": torch.zeros(1), "n": 3}) >= 0.0
    assert t.average_ms == pytest.approx(sum(t.samples) / 4)
    assert TPROF.FrameTimer().average_ms is None


def test_trace_annotate_and_commas(tmp_path):
    with TPROF.trace(tmp_path / "tr"):
        with TPROF.annotate("m2s_region"):
            torch.ones(64).sum()
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert any(e.get("name") == "m2s_region"
               for e in events["traceEvents"])
    for v in (0, 7, 1234, 1234567, -98765):
        assert TPROF.format_with_commas(v) == JPROF.format_with_commas(v)


def _quad():
    v = np.asarray([[-0.5, -0.5, 0], [0.5, -0.5, 0], [0.5, 0.5, 0],
                    [-0.5, 0.5, 0]], np.float32)
    return v, np.asarray([[0, 1, 2], [0, 2, 3]], np.uint32)


@pytest.mark.parametrize("variant", ["fallbacks", "full"])
def test_write_glb_round_trips_through_both_loaders(variant, tmp_path):
    """The port's write_glb read by both packages' load_glb: the same
    triangles and material; with a node matrix and without normals and
    tangents (the loaders' fallbacks), or with every attribute and a
    texture."""
    import io

    from PIL import Image

    v, idx = _quad()
    uv = v[:, :2] + 0.5
    kw = dict(uvs=uv, metallic_factor=0.25, roughness_factor=0.75,
              base_color_factor=(0.5, 0.6, 0.7, 1.0))
    if variant == "fallbacks":
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = [0.5, -1.0, 2.0]
        m[0, 0] = 2.0
        kw["node_matrix"] = m
    else:
        tex = np.random.default_rng(1).integers(0, 255, (8, 8, 4),
                                                dtype=np.uint8)
        buf = io.BytesIO()
        Image.fromarray(tex).save(buf, format="PNG")
        kw.update(normals=np.broadcast_to([0, 0, 1.0], (4, 3)),
                  tangents=np.broadcast_to([1, 0, 0, 1.0], (4, 4)),
                  base_color_png=buf.getvalue())
    path = tmp_path / "q.glb"
    TG.write_glb(path, v, idx, **kw)
    (tp,), (jp,) = TG.load_glb(path), JG.load_glb(path)
    for f in ("tri_pos", "tri_normal", "tri_uv", "tri_tangent",
              "base_color_factor"):
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f),
                                      err_msg=f)
    assert (tp.metallic_factor, tp.roughness_factor) == (0.25, 0.75)
    want = v[idx]
    if variant == "fallbacks":
        want = want * [2.0, 1.0, 1.0] + [0.5, -1.0, 2.0]
        np.testing.assert_allclose(tp.tri_normal,
                                   np.broadcast_to([0, 0, 1.0], (2, 3, 3)),
                                   atol=1e-6)
        assert tp.base_color_tex is None
    else:
        np.testing.assert_array_equal(tp.base_color_tex, jp.base_color_tex)
        assert tp.base_color_tex.shape == (8, 8, 4)
    np.testing.assert_allclose(tp.tri_pos, want, atol=1e-6)
