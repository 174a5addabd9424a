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


def _projected_sparse(n=400, seed=5, big=10):
    """A JAX projection in which almost every splat is single-tile (tiny,
    moved to a tile's middle) or invalid, so that almost every class-C
    count is 0; ``big`` splats at random indices are widened to span
    several tiles."""
    p = host(j_proj(random_splats(n, seed=seed, scale=(2e-4, 1e-3))))
    rng = np.random.default_rng(seed)
    tx, ty = rng.integers(0, W // 32, n), rng.integers(0, H // 32, n)
    px = 32 * tx + 16 + rng.uniform(-8, 8, n)
    py = 32 * ty + 16 + rng.uniform(-8, 8, n)
    ndc = np.stack([px / (W / 2) - 1, py / (H / 2) - 1], -1)
    wide = rng.choice(n, big, replace=False)
    ndc[wide] = rng.uniform(-0.9, 0.9, (big, 2))
    p["mean_ndc"] = ndc.astype(np.float32)
    p["axes_px"] = p["axes_px"].copy()
    p["axes_px"][wide] *= 12.0
    p["valid"] = p["valid"] & (rng.uniform(size=n) >= 0.3)
    return p


@pytest.mark.parametrize("variant,c_capacity", [
    ("full", 0), ("albedo", 0), ("full", 64), ("depth", 0),
    ("depth-band", 0), ("overdraw", 0), ("albedo-sparse", 0),
    ("full-sparse", 0), ("depth-band-sparse", 0), ("albedo-sparse", 16)])
def test_binning_exact(variant, c_capacity):
    """Same numpy ProjectedSplats in, identical tile ranges, counts, drops
    and pair fields out (the stable torch.sort orders as lax.sort does).
    The "depth" and "overdraw" variants are binned as the JAX package bins
    them for shadows and overdraw (without its row-id key); "band" adds a
    per-splat tile-row band (the cubemap's face scissor): one tile row for
    some splats, both for others. "sparse" bins a projection whose class-C
    counts are almost all 0, with zero runs at both ends, so that the
    owners of dead class-C rows (padding included) are held too."""
    variant, *opts = variant.split("-")
    banded, sparse = "band" in opts, "sparse" in opts
    p = _projected_sparse() if sparse else _projected_with_ties()
    from mesh2splat_tpu.ops.projection import ProjectedSplats as JP

    jp = JP(**{k: jnp.asarray(v) for k, v in p.items()})
    kw_j, kw_t = {}, {}
    if banded:
        lo = np.random.default_rng(0).integers(0, 2, p["depth"].shape[0],
                                               dtype=np.int32)
        hi = np.where(np.arange(lo.shape[0]) % 3 == 0, 1, lo).astype(np.int32)
        kw_j["band_ty"] = (jnp.asarray(lo), jnp.asarray(hi))
        kw_t["band_ty"] = (torch.from_numpy(lo), torch.from_numpy(hi))
    if variant in ("depth", "overdraw"):
        kw_j["differentiable"] = False
    ref = JB.bin_pairs(jp, W, H, c_capacity, variant=variant, **kw_j)
    out = TB.bin_pairs(state.projected(p, "cpu"), W, H, c_capacity,
                       variant=variant, **kw_t)
    np.testing.assert_array_equal(out.tile_starts.numpy(),
                                  np.asarray(ref.tile_starts))
    assert int(out.num_pairs) == int(ref.num_pairs) > 0
    assert int(out.dropped_pairs) == int(ref.dropped_pairs)
    assert (c_capacity > 0) == (int(out.dropped_pairs) > 0)
    if sparse:
        need = TB.required_overflow(state.projected(p, "cpu"), W, H,
                                    kw_t.get("band_ty"))
        assert 0 < int(need) < p["depth"].shape[0] // 10
    np.testing.assert_array_equal(out.fields.numpy(), np.asarray(ref.fields))
    assert int(TB.required_overflow(state.projected(p, "cpu"), W, H,
                                    kw_t.get("band_ty"))) == \
        int(JB.required_overflow(jp, W, H, kw_j.get("band_ty")))
    if banded:   # the band removes pairs
        assert int(out.num_pairs) < int(TB.bin_pairs(
            state.projected(p, "cpu"), W, H, variant=variant).num_pairs)


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
    """Every option that once raised now runs: FINAL with shadows (tiled
    cubemap, K5's plain version), the mesh depth prepass, the tiled
    OVERDRAW view (K6's plain version), the dense rasterizer
    (use_tiled=False) and the composite's gradient (K4)."""
    from mesh2splat_torch.render.pipeline import FrameConfig, render_frame
    from mesh2splat_torch.render.tiled import rasterize_tiled
    from torch_parity import sphere_mesh

    sp = state.splats(random_splats(20), "cpu")
    cam = state.camera(j_camera(**CAM), "cpu")
    mesh, _ = sphere_mesh(200, seed=2)
    tm = state.mesh(mesh, "cpu")
    for cfg, kw in ((FrameConfig(W, H, TRM.FINAL, shadows=True,
                                 shadow_size=512), {}),
                    (FrameConfig(W, H, depth_test_mesh=True), {"mesh": tm})):
        img = render_frame(sp, cam, cfg, **kw)
        assert img.shape == (H, W, 3) and bool(torch.isfinite(img).all())
    dense = render_frame(sp, cam, FrameConfig(W, H, use_tiled=False))
    tiled = render_frame(sp, cam, FrameConfig(W, H))
    assert dense.shape == (H, W, 3) and float(dense.max()) > 0.05
    # the tiled path against its ground truth (tests/test_tiled.py's 5e-3)
    assert float((dense - tiled).abs().max()) <= 5e-3
    proj = t_project(sp, cam)
    over = rasterize_tiled(proj, W, H, render_mode=TRM.OVERDRAW)
    assert float(over["albedo"][..., 3].max()) >= 0.01
    # no pair in any tile: the K4 plain path returns an all-zero gradient
    fields = torch.ones((24, 128), requires_grad=True)
    out = TCOMP.composite_tiles(fields, torch.zeros(9, dtype=torch.int32), H,
                                2, 4)
    out.sum().backward()
    assert fields.grad.shape == (24, 128) and not fields.grad.any()


def test_overdraw_plain_matches():
    """K6's plain version against the JAX overdraw kernel in interpret mode
    on the same binned pairs: the same counts."""
    proj = j_proj(random_splats(300, seed=123), fmt=1)
    binned = JB.bin_pairs(proj, W, H, 0, variant="overdraw",
                          differentiable=False)
    ty, tx = JB.tiles_for(W, H)
    ref = np.asarray(JCOMP.overdraw_tiles(
        binned, jnp.asarray([H], jnp.int32), ty, tx, True))
    out = TCOMP.overdraw_tiles(
        TB.BinnedPairs(*(torch.from_numpy(np.array(getattr(binned, f)))
                         for f in ("fields", "tile_starts", "num_pairs",
                                   "dropped_pairs"))), H, ty, tx).numpy()
    assert ref.max() >= 5
    np.testing.assert_array_equal(out, ref)


def test_overdraw_tiled_matches():
    """rasterize_tiled(OVERDRAW) against the JAX package and against the
    port's dense rasterizer (tests/test_tiled.py's check), within 1e-5."""
    from mesh2splat_tpu.render.tiled import rasterize_tiled as j_tiled
    from mesh2splat_torch.render.rasterize import rasterize_dense
    from mesh2splat_torch.render.tiled import rasterize_tiled

    sp = random_splats(300, seed=123)
    ref = j_tiled(j_proj(sp, fmt=1), W, H, render_mode=JRM.OVERDRAW,
                  interpret=True)
    proj = t_project(state.splats(sp, "cpu"),
                     state.camera(j_camera(**CAM), "cpu"),
                     splat_format=TSF.PLY_3DGS)
    out = rasterize_tiled(proj, W, H, render_mode=TRM.OVERDRAW)
    dense = rasterize_dense(proj, W, H, render_mode=TRM.OVERDRAW,
                            device="cpu")
    for k in ("albedo", "position", "normal", "depth", "metal_rough",
              "transmittance"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(out["albedo"].numpy(),
                               dense["albedo"].numpy(), atol=1e-5)
    assert int(out["dropped_pairs"]) == int(ref["dropped_pairs"]) == 0
    assert float(out["albedo"][..., 3].max()) >= 0.05
