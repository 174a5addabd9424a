"""Shadows in mesh2splat_torch vs mesh2splat_tpu: the face assignment and
cameras, the fused single-pass shadow prep, the min-depth walk (the plain
version of K5) on the same binned pairs, whole cubemaps (tiled and dense),
cubemap sampling and PCF, and a FINAL frame with shadows."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mesh2splat_tpu.ops.conversion import ConversionConfig as JConvConfig
from mesh2splat_tpu.ops.conversion import convert as j_convert
from mesh2splat_tpu.render import binning as JB
from mesh2splat_tpu.render import composite as JCOMP
from mesh2splat_tpu.render import shadows as JS
from mesh2splat_tpu.render.pipeline import FrameConfig as JFrameConfig
from mesh2splat_tpu.render.pipeline import render_frame as j_render_frame
from mesh2splat_tpu.types import Material as JMaterial
from mesh2splat_tpu.types import RenderMode as JRM
from mesh2splat_tpu.types import Splats as JSplats
from mesh2splat_tpu.types import compose_trs as j_compose_trs
from mesh2splat_tpu.types import make_camera as j_camera

from mesh2splat_torch import state
from mesh2splat_torch.render import binning as TB
from mesh2splat_torch.render import composite as TCOMP
from mesh2splat_torch.render import shadows as TS
from mesh2splat_torch.render.pipeline import FrameConfig, render_frame
from mesh2splat_torch.types import RenderMode as TRM
from mesh2splat_torch.types import compose_trs
from torch_parity import host

SIZE = 64


def scene(name):
    """(numpy splat fields, light, far): the scenes of tests/test_shadows.py
    and, "random", oriented splats of several sizes around the light."""
    if name == "occluder":    # one blob on +X, the light at the origin
        n, total = 1, 1
        pos = np.asarray([[1.0, 0, 0]], np.float32)
        fields = dict(pos=pos, color=np.ones((1, 4), np.float32),
                      scale=np.full((1, 3), 0.2, np.float32))
        light, far = [0.0, 0.0, 0.0], 10.0
    else:
        rng = np.random.default_rng({"opaque": 7, "model": 11,
                                     "random": 5}[name])
        n = total = {"opaque": 400, "model": 200, "random": 300}[name]
        pos = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
        if name == "model":
            pos *= 0.8
        fields = dict(pos=pos, color=np.concatenate(
            [rng.uniform(0, 1, (n, 3)), np.ones((n, 1))], -1)
            .astype(np.float32),
            scale=np.full((n, 3), {"opaque": 0.03, "model": 0.05,
                                   "random": 0.04}[name], np.float32))
        light, far = {"opaque": ([0.0, 0.0, 3.0], 10.0),
                      "model": ([0.0, 0.5, 3.0], 10.0),
                      "random": ([0.2, -0.1, 0.3], 4.0)}[name]
    quat = np.tile([1.0, 0, 0, 0], (total, 1)).astype(np.float32)
    if name == "random":
        quat = rng.normal(size=(n, 4)).astype(np.float32)
        quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
        fields["scale"] = rng.uniform(0.005, 0.04, (n, 3)).astype(np.float32)
    sp = dict(fields, normal=np.tile([0, 0, 1.0], (total, 1))
              .astype(np.float32), quat=quat,
              pbr=np.full((total, 2), 0.5, np.float32),
              valid=np.ones((total,), bool))
    return sp, np.asarray(light, np.float32), far


def jsplats(sp):
    return JSplats(**{k: jnp.asarray(v) for k, v in sp.items()})


TRS = dict(translation=(0.1, 0.2, -0.1), rotation_wxyz=(0.9, 0.1, 0.4, -0.1),
           scale=(1.2, 0.8, 1.05))


def test_dominant_face_and_face_cameras():
    d = np.asarray([[1, 0.1, 0.1], [-1, 0, 0], [0.1, 2, 0], [0, -3, 0.1],
                    [0, 0, 5], [0.1, 0, -4], [2, -2, 1], [-0.0, 0.0, -0.0]],
                   np.float32)
    got = TS.dominant_face(torch.from_numpy(d)).numpy()
    np.testing.assert_array_equal(got, np.asarray(JS.dominant_face(
        jnp.asarray(d))))
    np.testing.assert_array_equal(got[:6], [0, 1, 2, 3, 4, 5])
    light = np.asarray([0.3, -1.2, 2.5], np.float32)
    for jc, tc in zip(JS.face_cameras(jnp.asarray(light), 10.0, 32),
                      TS.face_cameras(torch.from_numpy(light), 10.0, 32)):
        np.testing.assert_array_equal(tc.world_to_view.numpy(),
                                      np.asarray(jc.world_to_view))
        np.testing.assert_array_equal(tc.view_to_clip.numpy(),
                                      np.asarray(jc.view_to_clip))
        assert (tc.width, tc.height, tc.near, tc.far) == (
            jc.width, jc.height, float(jc.near), float(jc.far))


@pytest.mark.parametrize("name,model", [("random", False), ("model", True)])
def test_shadow_prep_fused_matches(name, model):
    """The merged projection, band and class-C need against the jitted JAX
    prep: integers exact, floats within 1e-5, the quad axes within rtol
    1e-3 (the reference's approximate rsqrt, as test_projection_matches)."""
    sp, light, far = scene(name)
    m_j = j_compose_trs(**TRS) if model else None
    m_t = compose_trs(**TRS, device="cpu") if model else None
    jm, jband, jneed = JS._shadow_prep_fused(
        jsplats(sp), jnp.asarray(light), jnp.float32(far), 1.0, SIZE, m_j)
    tm, tband, tneed = TS._shadow_prep_fused(
        state.splats(sp, "cpu"), torch.from_numpy(light), torch.tensor(far),
        1.0, SIZE, m_t)
    ref, out = host(jm), host(tm)
    np.testing.assert_array_equal(out["valid"], ref["valid"])
    v = ref["valid"]
    assert v.sum() > 0.9 * v.size
    for a, b in zip(tband, jband):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(tneed) == int(jneed) > 0
    for k in ("mean_ndc", "conic", "depth", "wspos"):
        np.testing.assert_allclose(out[k][v], ref[k][v], atol=1e-5,
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(out["axes_px"][v], ref["axes_px"][v],
                               atol=1e-5, rtol=1e-3)


@pytest.mark.parametrize("name", ["random", "opaque"])
def test_min_depth_plain_matches(name):
    """K5's plain version against the JAX min-depth kernel in interpret mode
    on the same band-clamped binned pairs of the tall cubemap image: the
    same bits (a minimum of the same depths under the same coverage)."""
    sp, light, far = scene(name)
    merged, band, need = JS._shadow_prep_fused(
        jsplats(sp), jnp.asarray(light), jnp.float32(far), 1.0, SIZE)
    h = 6 * SIZE
    binned = JB.bin_pairs(merged, SIZE, h, JB.round_pow2_budget(need),
                          variant="depth", differentiable=False, band_ty=band)
    ty, tx = JB.tiles_for(SIZE, h)
    ref = np.asarray(JCOMP.min_depth_tiles(
        binned, jnp.asarray([h], jnp.int32), ty, tx, True))
    out = TCOMP.min_depth_tiles(
        TB.BinnedPairs(*(torch.from_numpy(np.array(getattr(binned, f.name)))
                         for f in dataclasses.fields(TB.BinnedPairs))),
        h, ty, tx).numpy()
    covered = ref < 1e37
    assert 0.02 < covered.mean() < 0.98
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("name,method", [
    ("opaque", "tiled"), ("opaque", "dense"), ("random", "tiled"),
    ("random", "dense"), ("occluder", "auto")])
def test_cubemap_matches(name, method):
    """Whole cubemaps against the JAX package at size 64: coverage agrees on
    >= 99.9 % of pixels and depth within 1e-5 where both cover."""
    sp, light, far = scene(name)
    ref = np.asarray(JS.render_shadow_cubemap(
        jsplats(sp), light, far, std_dev=1.0, size=SIZE, method=method).faces)
    cm = TS.render_shadow_cubemap(state.splats(sp, "cpu"), light, far,
                                  std_dev=1.0, size=SIZE, method=method,
                                  device="cpu")
    out = cm.faces.numpy()
    assert out.shape == (6, SIZE, SIZE)
    cov_r, cov_o = ref < 1.0, out < 1.0
    assert cov_r.mean() > 0.005
    assert (cov_r == cov_o).mean() >= 0.999
    both = cov_r & cov_o
    np.testing.assert_allclose(out[both], ref[both], atol=1e-5)
    if name == "occluder":   # tests/test_shadows.py's occluder checks
        assert out[0, 32, 32] < 0.2
        pts = torch.tensor([[3.0, 0, 0], [0.5, 0, 0], [-3.0, 0, 0]])
        shadow = TS.pcf_shadow_factor(cm, pts).numpy()
        assert shadow[0] > 0.9 and shadow[1] < 0.1 and shadow[2] < 0.1


def test_model_transform_moved_equals_baked():
    """A translated model gives the cubemap of splats with the translation
    baked in (within 1e-5), differs from the untransformed one, and a full
    TRS agrees with the JAX package's tiled cubemap (coverage >= 99.9 %,
    depth within 1e-5 where both cover)."""
    sp, light, far = scene("model")
    d = np.array([0.3, -0.1, 0.2], np.float32)
    kw = dict(std_dev=1.0, size=SIZE, method="tiled", device="cpu")
    moved = TS.render_shadow_cubemap(
        state.splats(sp, "cpu"), light, far,
        model_to_world=compose_trs(translation=d, device="cpu"), **kw).faces
    baked = TS.render_shadow_cubemap(
        state.splats(dict(sp, pos=sp["pos"] + d), "cpu"), light, far,
        **kw).faces
    base = TS.render_shadow_cubemap(state.splats(sp, "cpu"), light, far,
                                    **kw).faces
    np.testing.assert_allclose(moved.numpy(), baked.numpy(), atol=1e-5)
    assert float((moved - base).abs().max()) > 1e-3

    out = TS.render_shadow_cubemap(
        state.splats(sp, "cpu"), light, far,
        model_to_world=compose_trs(**TRS, device="cpu"), **kw).faces.numpy()
    ref = np.asarray(JS.render_shadow_cubemap(
        jsplats(sp), light, far, std_dev=1.0, size=SIZE, method="tiled",
        model_to_world=j_compose_trs(**TRS)).faces)
    cov_r, cov_o = ref < 1.0, out < 1.0
    assert cov_r.mean() > 0.005 and (cov_r == cov_o).mean() >= 0.999
    both = cov_r & cov_o
    np.testing.assert_allclose(out[both], ref[both], atol=1e-5)


@pytest.mark.parametrize("filter_linear", [False, True])
def test_sample_cubemap_and_pcf(filter_linear):
    """sample_cubemap (nearest and bilinear) and the 20-tap PCF on the same
    faces and points, within 1e-6 (JAX jitted, as the frame runs it)."""
    rng = np.random.default_rng(3)
    faces = rng.uniform(0.05, 1.0, (6, 16, 16)).astype(np.float32)
    dirs = rng.normal(size=(500, 3)).astype(np.float32)
    dirs[:6] = [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1],
                [0, 0, -1]]
    ref = np.asarray(jax.jit(JS.sample_cubemap, static_argnums=2)(
        jnp.asarray(faces), jnp.asarray(dirs), filter_linear))
    out = TS.sample_cubemap(torch.from_numpy(faces), torch.from_numpy(dirs),
                            filter_linear).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)

    light = np.asarray([0.2, 0.1, -0.3], np.float32)
    pts = rng.uniform(-3, 3, (400, 3)).astype(np.float32)
    jcm = JS.ShadowCubemap(faces=jnp.asarray(faces * 0.3),
                           light_pos=jnp.asarray(light),
                           far=jnp.float32(10.0))
    ref = np.asarray(jax.jit(JS.pcf_shadow_factor)(jcm, jnp.asarray(pts)))
    tcm = state.shadow_cubemap(jcm, "cpu")
    out = TS.pcf_shadow_factor(tcm, torch.from_numpy(pts)).numpy()
    assert 0.05 < ref.mean() < 0.95
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_final_frame_with_shadows_matches():
    """tests/test_pipeline_full.py's FINAL frame with shadows (the converted
    quad, dense raster, 32^2 cubemap) against the JAX package, within
    1e-3."""
    from torch_parity import jax_mesh_material

    v = np.array([[-0.5, -0.5, 0], [0.5, -0.5, 0], [0.5, 0.5, 0],
                  [-0.5, 0.5, 0]], np.float32)
    tris = np.array([[0, 1, 2], [0, 2, 3]])
    mesh = dict(tri_pos=v[tris],
                tri_normal=np.broadcast_to([0, 0, 1.0], (2, 3, 3))
                .astype(np.float32),
                tri_tangent=np.broadcast_to([1, 0, 0, 1.0], (2, 3, 4))
                .astype(np.float32),
                tri_uv=(v[tris][..., :2] + 0.5).astype(np.float32))
    jm, _ = jax_mesh_material(mesh, dict(
        base_color_factor=np.ones(4, np.float32), metallic_factor=1.0,
        roughness_factor=1.0, base_color=np.ones((1, 1, 4), np.float32),
        normal=np.full((1, 1, 3), 0.5, np.float32),
        metallic_roughness=np.zeros((1, 1, 3), np.float32)))
    cfg = JConvConfig(resolution=16, layers=2)
    splats = j_convert(jm, JMaterial.default(), *jm.bbox(), cfg)
    cam = j_camera(eye=[0, 0, 2], center=[0, 0, 0], up=[0, 1, 0],
                   fov_y_rad=np.pi / 3, width=64, height=64)
    kw = dict(width=64, height=64, gaussian_std=1.0,
              resolution_target=cfg.resolution, use_tiled=False,
              shadows=True, shadow_size=32)
    ref = np.asarray(j_render_frame(splats, cam, JFrameConfig(
        render_mode=JRM.FINAL, **kw)))
    out = render_frame(state.splats(host(splats), "cpu"),
                       state.camera(cam, "cpu"),
                       FrameConfig(render_mode=TRM.FINAL, **kw)).numpy()
    assert out.shape == (64, 64, 3) and np.isfinite(out).all()
    assert out[32, 32].mean() > 0.02
    np.testing.assert_allclose(out, ref, atol=1e-3)
