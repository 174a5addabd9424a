"""The mesh rasterizer, the depth-tested frame and the split-screen compare
in mesh2splat_torch vs mesh2splat_tpu (the scenes of
tests/test_mesh_raster.py and tests/test_pipeline_full.py, and a textured
sphere with a normal map).

Vertex positions reach the window through a 4x4 matrix product, which the
two libraries sum in different orders, and the JAX package fuses the edge
functions' multiply-adds: a pixel whose centre lies on a triangle edge may
change triangle. Such pixels are counted; every other pixel is held to the
stated tolerance."""

import dataclasses

import numpy as np
import pytest
import torch

from mesh2splat_tpu.ops.conversion import ConversionConfig as JConvConfig
from mesh2splat_tpu.ops.conversion import convert as j_convert
from mesh2splat_tpu.render import pipeline as JP
from mesh2splat_tpu.render.mesh_raster import rasterize_mesh as j_raster
from mesh2splat_tpu.types import Material as JMaterial
from mesh2splat_tpu.types import RenderMode as JRM
from mesh2splat_tpu.types import compose_trs as j_compose_trs
from mesh2splat_tpu.types import make_camera as j_camera

from mesh2splat_torch import state
from mesh2splat_torch.render import pipeline as TP
from mesh2splat_torch.render.mesh_raster import rasterize_mesh
from mesh2splat_torch.types import Material, RenderMode, compose_trs
from torch_parity import host, jax_mesh_material, sphere_mesh

PX = 64
TARGETS = ("albedo", "position", "normal", "depth", "metal_rough",
           "transmittance")


def quad(z=0.0, size=0.5):
    v = np.array([[-size, -size, z], [size, -size, z], [size, size, z],
                  [-size, size, z]], np.float32)
    tris = np.array([[0, 1, 2], [0, 2, 3]])
    return dict(
        tri_pos=v[tris],
        tri_normal=np.broadcast_to([0, 0, 1.0], (2, 3, 3)).astype(np.float32),
        tri_tangent=np.broadcast_to([1, 0, 0, 1.0], (2, 3, 4))
        .astype(np.float32),
        tri_uv=(v[tris][..., :2] / (2 * size) + 0.5).astype(np.float32))


def default_material(**kw):
    mat = dict(base_color_factor=np.ones(4, np.float32), metallic_factor=1.0,
               roughness_factor=1.0, base_color=np.ones((1, 1, 4), np.float32),
               normal=np.full((1, 1, 3), 0.5, np.float32),
               metallic_roughness=np.zeros((1, 1, 3), np.float32))
    mat.update(kw)
    return mat


def scene(name):
    """(numpy mesh, numpy material, camera eye)."""
    if name == "quad":
        return quad(), default_material(), (0, 0, 2)
    if name == "two_quads":     # the nearer small quad wins the z-test
        q1, q2 = quad(0.0), quad(0.5, 0.25)
        return ({k: np.concatenate([q1[k], q2[k]]) for k in q1},
                default_material(), (0, 0, 2))
    if name == "normal_map":    # tangent-space +X -> world +X on the quad
        nmap = np.asarray([[[1.0, 0.5, 0.5]]], np.float32)
        return quad(), default_material(normal=nmap, has_normal=True), \
            (0, 0, 2)
    mesh, mat = sphere_mesh(600, seed=3)
    return mesh, mat, (0.4, 0.6, 2.6)


def cams(eye):
    jc = j_camera(eye=list(eye), center=[0, 0, 0], up=[0, 1, 0],
                  fov_y_rad=np.pi / 3, width=PX, height=PX)
    return jc, state.camera(jc, "cpu")


@pytest.mark.parametrize("name", ["quad", "two_quads", "normal_map",
                                  "sphere"])
@pytest.mark.parametrize("mode", list(RenderMode))
def test_rasterize_mesh_matches(name, mode):
    """Every target of the mesh G-buffer in every render mode, and the
    window depth map, against the JAX package: at most 1 % of the pixels
    (triangle edges) differ by more than 1e-3; the rest agree within 1e-4
    (the normal map's renormalisations) and depth_ndc within 1e-6. The
    GEOMETRY colours are sin hashes of the triangle index amplified by
    43758, which the two libraries' sin part for large indices: there the
    pixels must fall into the same triangles (colour classes), and the
    colours agree within 1e-2 on the quads (indices 0-3)."""
    mesh, mat, eye = scene(name)
    jc, tc = cams(eye)
    jm, jmat = jax_mesh_material(mesh, mat)
    ref_g, ref_d = j_raster(jm, jmat, jc, PX, PX, render_mode=JRM(int(mode)))
    tm, tmat = state.mesh(mesh, "cpu"), state.material(mat, "cpu")
    out_g, out_d = rasterize_mesh(tm, tmat, tc, PX, PX, render_mode=mode,
                                  device="cpu")
    out = state.gbuffer_to_numpy(out_g)
    ref = {k: np.asarray(v) for k, v in ref_g.items()}
    assert out["transmittance"].min() == 0.0      # the mesh covers pixels
    geometry = mode == RenderMode.GEOMETRY
    edges = np.zeros(PX * PX, bool)
    for k in TARGETS:
        if geometry and k == "albedo":
            continue
        d = np.abs(out[k] - ref[k]).reshape(PX * PX, -1).max(-1)
        edges |= d > 1e-3
        assert d[d <= 1e-3].max(initial=0.0) <= 1e-4, k
    if geometry:
        # each port colour class to the JAX class it mostly covers; the
        # pixels where they part changed triangle
        ids = [np.unique(g["albedo"].reshape(-1, 4), axis=0,
                         return_inverse=True)[1].reshape(-1)
               for g in (out, ref)]
        to_ref = {c: np.bincount(ids[1][ids[0] == c]).argmax()
                  for c in np.unique(ids[0])}
        assert len(set(to_ref.values())) == len(to_ref) == ids[1].max() + 1
        moved = np.asarray([to_ref[c] for c in ids[0]]) != ids[1]
        edges |= moved
        if name != "sphere":
            d = np.abs(out["albedo"] - ref["albedo"]).reshape(PX * PX, -1)
            assert d[~moved].max() <= 1e-2
    assert edges.mean() <= 0.01, edges.sum()
    edges = edges.reshape(PX, PX)
    dd = np.abs(out_d.numpy() - np.asarray(ref_d))
    assert (dd > 1e-6).mean() <= 0.01 and dd[~edges].max() <= 1e-6


def test_opaque_only_skips_transparent_mesh():
    mesh, mat, eye = scene("quad")
    jc, tc = cams(eye)
    mat = dict(mat, base_color_factor=np.asarray([1, 1, 1, 0.5], np.float32))
    _, depth = rasterize_mesh(state.mesh(mesh, "cpu"),
                              state.material(mat, "cpu"), tc, PX, PX,
                              opaque_only=True, device="cpu")
    assert bool((depth == 1.0).all())
    _, depth = rasterize_mesh(state.mesh(mesh, "cpu"),
                              state.material(default_material(), "cpu"), tc,
                              PX, PX, opaque_only=True, device="cpu")
    assert float(depth[32, 32]) < 1.0


def _converted_quad(res):
    """tests/test_pipeline_full.py's setup: the unit quad converted by the
    JAX package, its splats carried across."""
    mesh = quad()
    jm, _ = jax_mesh_material(mesh, default_material())
    cfg = JConvConfig(resolution=res, layers=2)
    splats = j_convert(jm, JMaterial.default(), *jm.bbox(), cfg)
    return mesh, splats, cfg


@pytest.mark.parametrize("use_tiled,model", [(False, False), (True, False),
                                             (False, True)])
def test_depth_tested_frame_matches(use_tiled, model):
    """tests/test_pipeline_full.py's occlusion culling: the converted quad
    behind an opaque mesh quad 0.5 nearer; with depth_test_mesh the splats
    vanish. Images against the JAX package within 1e-3, with and without
    the test, and with a model matrix (the mesh is moved with the
    splats)."""
    mesh, splats, cfg = _converted_quad(16)
    front = dict(mesh, tri_pos=mesh["tri_pos"] + np.asarray(
        [0, 0, 0.5], np.float32))
    jc, tc = cams((0, 0, 2))
    jm, _ = jax_mesh_material(front, default_material())
    tm = state.mesh(front, "cpu")
    tsp = state.splats(host(splats), "cpu")
    trs = dict(translation=(0.05, -0.03, 0.0))
    for on in (False, True):
        kw = dict(width=PX, height=PX, render_mode=JRM.ALBEDO,
                  resolution_target=cfg.resolution, use_tiled=use_tiled,
                  depth_test_mesh=on)
        ref = np.asarray(JP.render_frame(
            splats, jc, JP.FrameConfig(**kw), mesh=jm,
            material=JMaterial.default(),
            model_to_world=j_compose_trs(**trs) if model else None))
        kw["render_mode"] = RenderMode.ALBEDO
        out = TP.render_frame(
            tsp, tc, TP.FrameConfig(**kw), mesh=tm,
            material=Material.default("cpu"),
            model_to_world=compose_trs(**trs, device="cpu") if model
            else None).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-3)
        if on:
            assert out[32, 32].mean() < 1e-3
        else:
            assert out[32, 32].mean() > 0.5


@pytest.mark.parametrize("mode", [RenderMode.ALBEDO, RenderMode.FINAL])
def test_split_screen_and_diff_metrics_match(mode):
    """render_split_screen (tests/test_pipeline_full.py's setup: the quad
    converted at resolution 32, dense raster) and image_diff_metrics
    against the JAX package: images within 1e-3, MAE and PSNR within
    1e-4 relative; the divider is white."""
    mesh, splats, cfg = _converted_quad(32)
    jc, tc = cams((0, 0, 2))
    jm, jmat = jax_mesh_material(mesh, default_material())
    kw = dict(width=PX, height=PX, resolution_target=cfg.resolution,
              use_tiled=False)
    ref = np.asarray(JP.render_split_screen(
        splats, jm, jmat, jc, JP.FrameConfig(render_mode=JRM(int(mode)),
                                             **kw)))
    tsp = state.splats(host(splats), "cpu")
    out = TP.render_split_screen(
        tsp, state.mesh(mesh, "cpu"), state.material(default_material(),
                                                      "cpu"), tc,
        TP.FrameConfig(render_mode=mode, **kw))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-3)
    assert np.allclose(out.numpy()[:, 32], 1.0) or \
        np.allclose(out.numpy()[:, 31], 1.0)

    mg, _ = j_raster(jm, jmat, jc, PX, PX)
    sg = JP.render_gbuffer(splats, jc, JP.FrameConfig(render_mode=JRM.ALBEDO,
                                                      **kw))
    ref_m = JP.image_diff_metrics(mg["albedo"][..., :3], sg["albedo"][..., :3])
    tg, _ = rasterize_mesh(state.mesh(mesh, "cpu"),
                           state.material(default_material(), "cpu"), tc, PX,
                           PX, device="cpu")
    tsg = TP.render_gbuffer(tsp, tc, TP.FrameConfig(
        render_mode=RenderMode.ALBEDO, **kw))
    out_m = TP.image_diff_metrics(tg["albedo"][..., :3], tsg["albedo"][..., :3])
    assert float(out_m["psnr"]) > 15.0
    for k in ("mae", "psnr"):
        np.testing.assert_allclose(float(out_m[k]), float(ref_m[k]),
                                   rtol=1e-4, err_msg=k)


def test_scene_render_split():
    """Scene.render_split on a two-primitive scene (one merged triangle
    soup, the first primitive's material) equals render_split_screen of
    the merged mesh."""
    from mesh2splat_torch.io.gltf import GltfPrimitive
    from mesh2splat_torch.io import gltf
    from mesh2splat_torch.scene import Scene
    from mesh2splat_torch.types import TriangleMesh

    prims = []
    for z, size in ((0.0, 0.5), (0.3, 0.2)):
        q = quad(z, size)
        prims.append(GltfPrimitive(
            name=f"q{z}", tri_pos=q["tri_pos"], tri_normal=q["tri_normal"],
            tri_tangent=q["tri_tangent"], tri_uv=q["tri_uv"],
            base_color_factor=np.asarray([0.9, 0.7, 0.5, 1], np.float32),
            metallic_factor=1.0, roughness_factor=1.0, base_color_tex=None,
            normal_tex=None, metallic_roughness_tex=None))
    sc = Scene(primitives=[(*gltf.to_device(p, "cpu"), p) for p in prims])
    sp = sc.convert(resolution=32, layers=2)
    img = sc.render_split(sp, eye=[0, 0, 2], width=PX, height=PX)
    assert img.shape == (PX, PX, 3) and bool(torch.isfinite(img).all())
    merged = TriangleMesh(**{f.name: torch.cat(
        [getattr(m, f.name) for m, _, _ in sc.primitives])
        for f in dataclasses.fields(TriangleMesh)})
    cam = state.camera(j_camera(eye=[0, 0, 2], center=[0, 0, 0],
                                up=[0, 1, 0], fov_y_rad=np.pi / 3, width=PX,
                                height=PX), "cpu")
    fc = TP.calibrate_frame(sp, cam, TP.FrameConfig(
        width=PX, height=PX, resolution_target=32))
    ref = TP.render_split_screen(sp, merged, sc.primitives[0][1], cam, fc)
    assert torch.equal(img, ref)
