"""Rendering in mesh2splat_torch vs mesh2splat_tpu: projection, binning on
the same projected splats, the composite forward (the plain version of K3)
on the same binned pairs, and the deferred resolve."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mesh2splat_tpu.ops.projection import project_splats as j_project
from mesh2splat_tpu.render import binning as JB
from mesh2splat_tpu.render import composite as JCOMP
from mesh2splat_tpu.render.lighting import PointLight as JLight
from mesh2splat_tpu.render.lighting import deferred_resolve as j_resolve
from mesh2splat_tpu.types import RenderMode as JRM
from mesh2splat_tpu.types import SplatFormat as JSF
from mesh2splat_tpu.types import Splats as JSplats
from mesh2splat_tpu.types import make_camera as j_camera

from mesh2splat_torch import state
from mesh2splat_torch.ops.projection import project_splats as t_project
from mesh2splat_torch.render import binning as TB
from mesh2splat_torch.render import composite as TCOMP
from mesh2splat_torch.render.lighting import PointLight as TLight
from mesh2splat_torch.render.lighting import deferred_resolve as t_resolve
from mesh2splat_torch.types import RenderMode as TRM
from mesh2splat_torch.types import SplatFormat as TSF
from torch_parity import host

W, H = 128, 64
CAM = dict(eye=[0, 0.2, 5], center=[0, 0, 0], up=[0, 1, 0],
           fov_y_rad=np.pi / 3, width=W, height=H)


def random_splats(n, seed=0, spread=1.0, alpha_max=0.95, scale=(0.02, 0.3)):
    """numpy splat fields (the shape of tests/test_tiled.py random_splats)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    return dict(
        pos=rng.uniform(-spread, spread, (n, 3)).astype(np.float32),
        color=(rng.uniform(0.05, 1.0, (n, 4))
               * np.array([1, 1, 1, alpha_max])).astype(np.float32),
        scale=rng.uniform(*scale, (n, 3)).astype(np.float32),
        normal=nrm.astype(np.float32),
        quat=q,
        pbr=rng.uniform(0, 1, (n, 2)).astype(np.float32),
        valid=np.ones((n,), bool),
    )


def j_proj(sp, mode=0, fmt=1):
    return j_project(JSplats(**{k: jnp.asarray(v) for k, v in sp.items()}),
                     j_camera(**CAM), std_dev=1.0, render_mode=JRM(mode),
                     splat_format=JSF(fmt))


@pytest.mark.parametrize("mode,fmt", [(0, 1), (6, 1), (0, 0), (2, 1)])
def test_projection_matches(mode, fmt):
    sp = random_splats(300, seed=mode + fmt)
    ref = host(j_proj(sp, mode, fmt))
    out = host(t_project(state.splats(sp, "cpu"),
                         state.camera(j_camera(**CAM), "cpu"), std_dev=1.0,
                         render_mode=TRM(mode), splat_format=TSF(fmt)))
    np.testing.assert_array_equal(out["valid"], ref["valid"])
    v = ref["valid"]
    assert v.sum() > 100
    for k in ("mean_ndc", "conic", "depth", "color", "normal", "wspos",
              "pbr"):
        np.testing.assert_allclose(out[k][v], ref[k][v], atol=1e-5,
                                   rtol=1e-5, err_msg=k)
    # the quad axes are the eigenvectors of the 2D covariance: for a nearly
    # isotropic splat they turn by many ulps when the conic moves by one
    # (the reference takes an approximate rsqrt and fuses its multiply-adds
    # in places the port does not), so they are held at rtol 1e-3
    np.testing.assert_allclose(out["axes_px"][v], ref["axes_px"][v],
                               atol=1e-5, rtol=1e-3)


def _projected_with_ties(n=400, seed=3):
    """A JAX projection whose depths carry exact ties and +-0.0."""
    p = host(j_proj(random_splats(n, seed=seed)))
    d = p["depth"].copy()
    d[10:40] = d[10]                 # a run of equal depths
    d[50:60] = 0.0
    d[60:70] = -0.0
    d[70:80] = d[200]
    p["depth"] = d
    return p


@pytest.mark.parametrize("variant,c_capacity", [
    ("full", 0), ("albedo", 0), ("full", 64)])
def test_binning_exact(variant, c_capacity):
    """Same numpy ProjectedSplats in, identical tile ranges, counts, drops
    and pair fields out (the stable torch.sort orders as lax.sort does)."""
    p = _projected_with_ties()
    from mesh2splat_tpu.ops.projection import ProjectedSplats as JP

    ref = JB.bin_pairs(JP(**{k: jnp.asarray(v) for k, v in p.items()}), W, H,
                       c_capacity, variant=variant)
    out = TB.bin_pairs(state.projected(p, "cpu"), W, H, c_capacity,
                       variant=variant)
    np.testing.assert_array_equal(out.tile_starts.numpy(),
                                  np.asarray(ref.tile_starts))
    assert int(out.num_pairs) == int(ref.num_pairs) > 0
    assert int(out.dropped_pairs) == int(ref.dropped_pairs)
    assert (c_capacity == 64) == (int(out.dropped_pairs) > 0)
    np.testing.assert_array_equal(out.fields.numpy(), np.asarray(ref.fields))
    assert int(TB.required_overflow(state.projected(p, "cpu"), W, H)) == \
        int(JB.required_overflow(JP(**{k: jnp.asarray(v)
                                       for k, v in p.items()}), W, H))


@pytest.mark.parametrize("albedo_only,dense", [
    (False, False), (True, False), (False, True), (True, True)])
def test_composite_plain_matches(albedo_only, dense):
    """K3 plain vs the JAX composite in interpret mode on the same binned
    pairs. The JAX kernel accumulates with bf16x3 matmuls (~2^-16 relative
    per term) and takes its transmittance as a tree product; the dense
    opaque scene ends every tile early."""
    if dense:   # large opaque splats over the whole image, 6 chunks deep
        sp = random_splats(800, seed=7, spread=3.5, alpha_max=1.0,
                           scale=(1.0, 2.0))
        sp["pos"][:, 2] *= 0.3
    else:
        sp = random_splats(200, seed=1)
    variant = "albedo" if albedo_only else "full"
    binned = JB.bin_pairs(j_proj(sp), W, H, 0, variant=variant)
    ty, tx = JB.tiles_for(W, H)
    ref = np.asarray(JCOMP.composite_tiles(
        binned.fields, binned.tile_starts, jnp.asarray([H], jnp.int32), ty,
        tx, True, albedo_only))
    out = TCOMP.composite_tiles(
        torch.from_numpy(np.array(binned.fields)),
        torch.from_numpy(np.array(binned.tile_starts)), H, ty, tx,
        albedo_only=albedo_only).numpy()
    if dense:   # every tile ended opaque, so the early exit fired
        assert ref[14].max() <= 1 / 255
    diff = np.abs(out - ref).max()
    print(f"K3 plain vs JAX ({variant}, dense={dense}): max diff {diff:.3g}")
    assert diff <= 1e-3


def _gbuffer(seed=0, h=24, w=40):
    rng = np.random.default_rng(seed)
    g = {k: rng.uniform(0.05, 1, (h, w, 4)).astype(np.float32)
         for k in ("albedo", "position", "normal", "depth", "metal_rough")}
    g["position"] = g["position"] * 2 - 1
    return g


@pytest.mark.parametrize("mode", [6, 5, 0])
def test_deferred_resolve_matches(mode):
    g = _gbuffer(mode)
    cam = np.asarray([0.2, 0.5, 3.0], np.float32)
    ref = np.asarray(j_resolve({k: jnp.asarray(v) for k, v in g.items()},
                               jnp.asarray(cam), JLight.default(),
                               render_mode=JRM(mode)))
    out = t_resolve({k: torch.from_numpy(v) for k, v in g.items()},
                    torch.from_numpy(cam), TLight.default("cpu"),
                    render_mode=TRM(mode)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_unported_options_raise():
    """K5, K6 and the mesh raster still raise; the dense rasterizer
    (use_tiled=False) and the composite's gradient (K4) now run."""
    from mesh2splat_torch.render.pipeline import FrameConfig, render_frame
    from mesh2splat_torch.render.tiled import rasterize_tiled

    sp = state.splats(random_splats(20), "cpu")
    cam = state.camera(j_camera(**CAM), "cpu")
    for cfg, what in ((FrameConfig(W, H, TRM.FINAL, shadows=True), "K5"),
                      (FrameConfig(W, H, depth_test_mesh=True), "mesh")):
        with pytest.raises(NotImplementedError, match=what):
            render_frame(sp, cam, cfg)
    dense = render_frame(sp, cam, FrameConfig(W, H, use_tiled=False))
    tiled = render_frame(sp, cam, FrameConfig(W, H))
    assert dense.shape == (H, W, 3) and float(dense.max()) > 0.05
    # the tiled path against its ground truth (tests/test_tiled.py's 5e-3)
    assert float((dense - tiled).abs().max()) <= 5e-3
    proj = t_project(sp, cam)
    with pytest.raises(NotImplementedError, match="K6"):
        rasterize_tiled(proj, W, H, render_mode=TRM.OVERDRAW)
    # no pair in any tile: the K4 plain path returns an all-zero gradient
    fields = torch.ones((24, 128), requires_grad=True)
    out = TCOMP.composite_tiles(fields, torch.zeros(9, dtype=torch.int32), H,
                                2, 4)
    out.sum().backward()
    assert fields.grad.shape == (24, 128) and not fields.grad.any()
