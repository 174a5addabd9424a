"""Gradients of mesh2splat_torch against mesh2splat_tpu on the CPU: the
composite VJP (the plain version of K4) against the JAX composite's VJP in
interpret mode, the sort carry, the projection and the tiled raster against
jax.grad, the port's tiled gradients against its dense rasterizer, a
finite-difference check, and the fragment VJP and conversion's texture
gradient against JAX.

Tolerances: the port's composite adds and multiplies in pair order, the JAX
kernel with bf16x3 matmuls and tree prefix products, so gradients of the
composite agree to about 1e-3 of each field row's largest magnitude
(measured: 2.2e-4). Pure data movement (the sort carry) agrees to f32
rounding of the scatter-add order. Tiled against dense uses the JAX suite's
own tolerance (tests/test_tiled.py: rtol 2e-2, atol 2e-3 / 2e-2)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mesh2splat_tpu.ops import conversion as JC
from mesh2splat_tpu.ops import fragment as JF
from mesh2splat_tpu.ops.projection import ProjectedSplats as JP
from mesh2splat_tpu.ops.projection import project_splats as j_project
from mesh2splat_tpu.render import binning as JB
from mesh2splat_tpu.render import composite as JCOMP
from mesh2splat_tpu.render.tiled import rasterize_tiled as j_tiled
from mesh2splat_tpu.types import SplatFormat as JSF
from mesh2splat_tpu.types import Splats as JSplats
from mesh2splat_tpu.types import make_camera as j_camera

from mesh2splat_torch import state
from mesh2splat_torch.ops import conversion as TC
from mesh2splat_torch.ops import fragment as TF
from mesh2splat_torch.ops.projection import project_splats as t_project
from mesh2splat_torch.render import binning as TB
from mesh2splat_torch.render import composite as TCOMP
from mesh2splat_torch.render.rasterize import rasterize_dense as t_dense
from mesh2splat_torch.render.tiled import rasterize_tiled as t_tiled
from mesh2splat_torch.types import SplatFormat as TSF
from torch_parity import assert_rows_close, gathered_taps, host, \
    jax_mesh_material, sphere_mesh, torch_mesh_material

W, H = 256, 64
CAM = dict(eye=[0, 0, 5], center=[0, 0, 0], up=[0, 1, 0],
           fov_y_rad=np.pi / 3, width=W, height=H)



@pytest.fixture(autouse=True)
def one_torch_thread():
    """These tests loop over many small torch ops: one thread each keeps
    them from contending with the suite's other workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def random_splats(n, seed=0, spread=1.0, alpha_max=0.95):
    """numpy fields of tests/test_tiled.py random_splats."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    nrm = rng.normal(size=(n, 3))
    return dict(
        pos=pos,
        color=(rng.uniform(0.05, 1.0, (n, 4)).astype(np.float32)
               * np.array([1, 1, 1, alpha_max], np.float32)),
        scale=rng.uniform(0.02, 0.3, (n, 3)).astype(np.float32),
        normal=(nrm / np.linalg.norm(nrm, axis=-1, keepdims=True))
        .astype(np.float32),
        quat=q,
        pbr=rng.uniform(0, 1, (n, 2)).astype(np.float32),
        valid=np.ones((n,), bool),
    )


def j_splats(sp, **over):
    fields = {k: jnp.asarray(v) for k, v in sp.items()}
    fields.update(over)
    return JSplats(**fields)


def t_splats(sp, grad=("pos", "color")):
    s = state.splats(sp, "cpu")
    for name in grad:
        getattr(s, name).requires_grad_(True)
    return s


def t_cam():
    return state.camera(j_camera(**CAM), "cpu")


def j_proj(s):
    return j_project(s, j_camera(**CAM), std_dev=1.0,
                     splat_format=JSF.PLY_3DGS, has_pbr=True)


def t_proj(s):
    return t_project(s, t_cam(), std_dev=1.0, splat_format=TSF.PLY_3DGS,
                     has_pbr=True)


# ---- K4: the composite VJP --------------------------------------------------


@pytest.mark.parametrize("albedo_only", [True, False])
def test_composite_backward_plain_matches_jax(albedo_only):
    """Same fields, tile_starts and a random cotangent: the plain K4 against
    the VJP of the JAX composite (its Pallas backward in interpret mode).
    Rows past num_pairs and padding rows come back zero in both."""
    variant = "albedo" if albedo_only else "full"
    binned = JB.bin_pairs(j_proj(j_splats(random_splats(200, seed=1))),
                          W, H, 0, variant=variant)
    ty, tx = JB.tiles_for(W, H)
    ct = np.random.default_rng(5).normal(
        size=(16, ty * 32, tx * 32)).astype(np.float32)
    _, vjp = jax.vjp(
        lambda f: JCOMP.composite_tiles(f, binned.tile_starts,
                                        jnp.asarray([H], jnp.int32), ty, tx,
                                        True, albedo_only), binned.fields)
    (ref,) = vjp(jnp.asarray(ct))
    ref = np.asarray(ref)

    fields = torch.from_numpy(np.array(binned.fields)).requires_grad_(True)
    starts = torch.from_numpy(np.array(binned.tile_starts))
    out = TCOMP.composite_tiles(fields, starts, H, ty, tx, albedo_only)
    out.backward(torch.from_numpy(ct))
    got = fields.grad.numpy()
    np.testing.assert_array_equal(
        got, TCOMP.composite_backward_plain(
            fields.detach(), starts, out.detach(), torch.from_numpy(ct), H,
            ty, tx, albedo_only).numpy())
    nf = len(TB.VARIANT_FIELDS[variant])
    n = int(binned.num_pairs)
    assert not got[nf:].any() and not got[:, n:].any()
    assert np.abs(ref[:nf]).max() > 1.0
    assert_rows_close(got[:nf], ref[:nf], 1e-3, variant)


# ---- the sort carry, projection and the tiled raster against jax.grad -------


def test_sort_carry_gradient_matches_jax():
    """bin_pairs' fields weighted by a random (F_pad, P) tensor: the
    gradient reaches the projected mean, conic and colour through the
    sorted gather and the class-C gather, as the JAX sort-carry VJP sends
    it; the integer outputs stay exactly equal with gradients enabled."""
    p = host(j_proj(j_splats(random_splats(120, seed=2))))
    jp = JP(**{k: jnp.asarray(v) for k, v in p.items()})
    binned = JB.bin_pairs(jp, W, H, 0, variant="full")
    wgt = np.random.default_rng(3).normal(
        size=binned.fields.shape).astype(np.float32)

    def j_loss(mean_ndc, conic, color):
        b = JB.bin_pairs(dataclasses.replace(jp, mean_ndc=mean_ndc,
                                             conic=conic, color=color),
                         W, H, 0, variant="full")
        return jnp.sum(b.fields * wgt)

    ref = jax.grad(j_loss, argnums=(0, 1, 2))(jp.mean_ndc, jp.conic,
                                              jp.color)
    tp = state.projected(p, "cpu")
    for name in ("mean_ndc", "conic", "color"):
        getattr(tp, name).requires_grad_(True)
    tb = TB.bin_pairs(tp, W, H, 0, variant="full")
    np.testing.assert_array_equal(tb.tile_starts.numpy(),
                                  np.asarray(binned.tile_starts))
    np.testing.assert_array_equal(tb.fields.detach().numpy(),
                                  np.asarray(binned.fields))
    (tb.fields * torch.from_numpy(wgt)).sum().backward()
    for name, r in zip(("mean_ndc", "conic", "color"), ref):
        np.testing.assert_allclose(getattr(tp, name).grad.numpy(),
                                   np.asarray(r), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_projection_gradient_matches_jax():
    """A weighted sum of every projected field, differentiated to the
    splats' pos, color, scale, quat, normal and pbr. XLA and the port round
    the projection's products differently (rtol 1e-3 of each gradient)."""
    sp = random_splats(150, seed=4)
    rng = np.random.default_rng(6)
    keys = ("mean_ndc", "conic", "depth", "color", "normal", "wspos", "pbr")
    p0 = host(j_proj(j_splats(sp)))
    v = p0["valid"]
    wts = {k: (rng.normal(size=p0[k].shape).astype(np.float32)
               * np.where(v, 1.0, 0.0).reshape((-1,) + (1,) * (p0[k].ndim - 1))
               .astype(np.float32)) for k in keys}
    # the conic of a small splat is large: scale its weight down
    wts["conic"] *= 1e-3
    names = ("pos", "color", "scale", "quat", "normal", "pbr")

    def j_loss(*vals):
        proj = j_proj(j_splats(sp, **dict(zip(names, vals))))
        return sum(jnp.sum(getattr(proj, k) * wts[k]) for k in keys)

    ref = jax.grad(j_loss, argnums=tuple(range(6)))(
        *[jnp.asarray(sp[k]) for k in names])
    ts = t_splats(sp, names)
    proj = t_proj(ts)
    np.testing.assert_array_equal(proj.valid.numpy(), v)
    sum((getattr(proj, k) * torch.from_numpy(wts[k])).sum()
        for k in keys).backward()
    for name, r in zip(names, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(getattr(ts, name).grad.numpy(), r,
                                   rtol=1e-3, atol=1e-3 * np.abs(r).max(),
                                   err_msg=name)


def _gbuffer_loss(out, wgt):
    """The five-target loss of tests/test_tiled.py:114-120."""
    return ((out["albedo"] * wgt).sum()
            + 0.3 * out["normal"][..., :3].sum()
            + 0.2 * (out["position"][..., :3] * wgt[..., :3]).sum()
            + 0.1 * out["depth"][..., 0].sum()
            + 0.1 * out["metal_rough"][..., :2].sum())


def test_tiled_gradient_matches_jax():
    """The port's tiled raster (projection, sort carry, plain K4) against
    jax.grad through the JAX tiled raster, both of the five-target loss,
    with respect to pos and color."""
    sp = random_splats(25, 4, alpha_max=0.9)
    wgt = np.random.default_rng(9).uniform(0, 1, (H, W, 4)).astype(np.float32)

    def j_loss(pos, color):
        out = j_tiled(j_proj(j_splats(sp, pos=pos, color=color)), W, H,
                      interpret=True)
        return _gbuffer_loss(out, jnp.asarray(wgt))

    ref = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(sp["pos"]),
                                           jnp.asarray(sp["color"]))
    ts = t_splats(sp)
    _gbuffer_loss(t_tiled(t_proj(ts), W, H), torch.from_numpy(wgt)).backward()
    for name, r in zip(("pos", "color"), ref):
        r = np.asarray(r)
        np.testing.assert_allclose(getattr(ts, name).grad.numpy(), r,
                                   rtol=1e-3, atol=1e-3 * np.abs(r).max(),
                                   err_msg=name)


# ---- the port against itself: dense ground truth, finite differences -------


def test_dense_forward_matches_jax():
    """The port's dense rasterizer against the JAX one, forward (same
    arithmetic, pair order and chunking)."""
    from mesh2splat_tpu.render.rasterize import rasterize_dense as j_dense

    sp = random_splats(200, seed=1)
    ref = j_dense(j_proj(j_splats(sp)), W, H)
    out = t_dense(t_proj(state.splats(sp, "cpu")), W, H, device="cpu")
    for key in ("albedo", "position", "normal", "depth", "metal_rough",
                "transmittance"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   atol=1e-5, err_msg=key)


def test_tiled_gradients_match_dense():
    """Mirror of tests/test_tiled.py::test_tiled_gradients_match_dense: the
    port's tiled gradients (plain K4) against autograd through the port's
    dense rasterizer, at the JAX suite's tolerance."""
    sp = random_splats(25, 4, alpha_max=0.9)
    wgt = torch.from_numpy(
        np.random.default_rng(9).uniform(0, 1, (H, W, 4)).astype(np.float32))
    grads = []
    for raster in (lambda p: t_dense(p, W, H, device="cpu"),
                   lambda p: t_tiled(p, W, H)):
        ts = t_splats(sp)
        _gbuffer_loss(raster(t_proj(ts)), wgt).backward()
        grads.append((ts.pos.grad.numpy(), ts.color.grad.numpy()))
    (gd_pos, gd_col), (gt_pos, gt_col) = grads
    np.testing.assert_allclose(gt_col, gd_col, rtol=2e-2, atol=2e-3)
    np.testing.assert_allclose(gt_pos, gd_pos, rtol=2e-2, atol=2e-2)


def test_tiled_gradient_finite_differences():
    """Mirror of tests/test_tiled.py::test_tiled_gradient_finite_differences
    (central differences of the tiled forward, same tolerance)."""
    sp = random_splats(10, 5, alpha_max=0.8)
    color0 = torch.from_numpy(sp["color"])

    def f(color):
        s = state.splats(sp, "cpu")
        s.color = color
        return (t_tiled(t_proj(s), W, H)["albedo"][..., 0] ** 2).sum()

    color = color0.clone().requires_grad_(True)
    f(color).backward()
    g = color.grad
    eps = 1e-3
    rng = np.random.default_rng(0)
    for _ in range(3):
        i, j = rng.integers(0, 10), rng.integers(0, 4)
        e = torch.zeros_like(color0)
        e[i, j] = eps
        with torch.no_grad():
            fd = (float(f(color0 + e)) - float(f(color0 - e))) / (2 * eps)
        assert abs(fd - float(g[i, j])) < 5e-2 * max(1.0, abs(fd)), \
            (i, j, fd, float(g[i, j]))


def test_albedo_only_matches_full():
    """Mirror of tests/test_tiled.py::test_albedo_only_matches_full: the
    albedo-only forward equals the full one and its gradient (K4 albedo)
    matches the full variant's (K4 full)."""
    sp = random_splats(60, 7)
    full = t_tiled(t_proj(state.splats(sp, "cpu")), W, H)
    fast = t_tiled(t_proj(state.splats(sp, "cpu")), W, H, albedo_only=True)
    np.testing.assert_allclose(fast["albedo"].numpy(), full["albedo"].numpy(),
                               atol=1e-6)
    grads = []
    for albedo_only in (False, True):
        ts = t_splats(sp, ("color",))
        (t_tiled(t_proj(ts), W, H, albedo_only=albedo_only)["albedo"] ** 2
         ).sum().backward()
        grads.append(ts.color.grad.numpy())
    np.testing.assert_allclose(grads[1], grads[0], rtol=1e-4, atol=1e-6)


# ---- the fragment VJP and conversion's texture gradient ----------------------


def _slot_inputs(mesh, mat, res, fast_rows=TF.FAST_ROWS):
    """The records, atlas, rows and meta that convert hands fragment_apply,
    and the f32 taps they gather (fast_rows: pack_factor's FAST_ROWS)."""
    tm, tmat = torch_mesh_material(mesh, mat)
    seen = {}
    real, fast = TF.fragment_apply, TF.FAST_ROWS

    def spy(records, tapsT, metaT, *args, **kw):
        seen.update(records=records, tapsT=gathered_taps(tapsT, kw),
                    atlasT=tapsT, rows=kw.get("rows"), metaT=metaT,
                    args=args)
        return real(records, tapsT, metaT, *args, **kw)

    TF.fragment_apply, TF.FAST_ROWS = spy, fast_rows
    try:
        TC.convert(tm, tmat, *tm.bbox(), TC.ConversionConfig(res, 6))
    finally:
        TF.fragment_apply, TF.FAST_ROWS = real, fast
    return seen


def test_fragment_vjp_matches_jax():
    """The port's fragment VJP against the JAX package's (jax.vjp of its
    _fragment_math) on the same records, f32 taps and meta, for a random
    cotangent of the live slots' outputs."""
    mesh, mat = sphere_mesh(150, seed=5, tex=16)
    s = _slot_inputs(mesh, mat, 32)
    res, geom, k, hb, hn, hm, packed = s["args"]
    assert not packed
    rec, taps, meta = (s[n].detach().numpy() for n in
                       ("records", "tapsT", "metaT"))
    out0, _ = TF.fragment_apply(*(torch.from_numpy(a) for a in (rec, taps, meta)),
                                res, geom, k, hb, hn, hm)
    live = out0[19].numpy() > 0
    g = (np.random.default_rng(7).normal(size=out0.shape)
         * live).astype(np.float32)
    g[19] = 0.0

    def j_fn(r, t):
        return JF.fragment_apply(r, t, jnp.asarray(meta), res, geom, k, hb,
                                 hn, hm, 0, False)[0]

    _, vjp = jax.vjp(j_fn, jnp.asarray(rec), jnp.asarray(taps))
    ref_rec, ref_taps = (np.asarray(a) for a in vjp(jnp.asarray(g)))

    trec = torch.from_numpy(rec).requires_grad_(True)
    ttaps = torch.from_numpy(taps).requires_grad_(True)
    out, _ = TF.fragment_apply(trec, ttaps, torch.from_numpy(meta), res, geom,
                               k, hb, hn, hm)
    out.backward(torch.from_numpy(g))
    assert np.abs(ref_taps).max() > 0 and np.abs(ref_rec).max() > 0
    assert_rows_close(ttaps.grad.numpy(), ref_taps, 1e-4, "taps")
    assert_rows_close(trec.grad.numpy()[:58], ref_rec[:58], 1e-3, "records")


# FAST_ROWS that make pack_factor pack k texels an atlas row of a 16^2
# texture (256 texels)
K_FAST_ROWS = {1: TF.FAST_ROWS, 2: 200, 4: 100}


@pytest.mark.parametrize("k,drop", [
    (1, ()), (2, ()), (4, ()), (2, ("has_normal", "has_metallic_roughness")),
    (4, ("has_base_color",))])
def test_fragment_vjp_rows_matches_jax(k, drop):
    """The fragment VJP when K2 reads the f32 atlas by K1's rows (the
    conversion's call): the gradients to the records and to the atlas
    against the JAX VJP through atlasT[:, rows] (jax.vjp of its
    fragment_apply on the gathered taps), within
    test_fragment_vjp_matches_jax's bounds, for k texels an atlas row and
    some maps absent; and the atlas gradient equal to the one through
    index_select, which the conversion ran before K2 read the atlas."""
    mesh, mat = sphere_mesh(150, seed=9 + k, tex=16)
    mat.update({name: False for name in drop})
    s = _slot_inputs(mesh, mat, 32, K_FAST_ROWS[k])
    res, geom, kk, hb, hn, hm, packed = s["args"]
    assert kk == k and not packed and s["rows"] is not None
    rec, atlas, meta = (s[n].detach().numpy() for n in
                        ("records", "atlasT", "metaT"))
    rows = s["rows"]
    out0, _ = TF.fragment_apply(torch.from_numpy(rec),
                                torch.from_numpy(atlas),
                                torch.from_numpy(meta), res, geom, k, hb, hn,
                                hm, rows=rows)
    live = out0[19].numpy() > 0
    g = (np.random.default_rng(k).normal(size=out0.shape)
         * live).astype(np.float32)
    g[19] = 0.0
    ridx = jnp.asarray(rows.numpy())

    def j_fn(r, a):
        return JF.fragment_apply(r, a[:, ridx], jnp.asarray(meta), res, geom,
                                 k, hb, hn, hm, 0, False)[0]

    _, vjp = jax.vjp(j_fn, jnp.asarray(rec), jnp.asarray(atlas))
    ref_rec, ref_atlas = (np.asarray(a) for a in vjp(jnp.asarray(g)))

    grads = []
    for gather_first in (False, True):
        trec = torch.from_numpy(rec).requires_grad_(True)
        tatlas = torch.from_numpy(atlas).requires_grad_(True)
        if gather_first:
            out, _ = TF.fragment_apply(trec, tatlas.index_select(1, rows),
                                       torch.from_numpy(meta), res, geom, k,
                                       hb, hn, hm)
        else:
            out, _ = TF.fragment_apply(trec, tatlas, torch.from_numpy(meta),
                                       res, geom, k, hb, hn, hm, rows=rows)
        out.backward(torch.from_numpy(g))
        grads.append((trec.grad.numpy(), tatlas.grad.numpy()))
    assert np.abs(ref_atlas).max() > 0 and np.abs(ref_rec).max() > 0
    assert_rows_close(grads[0][1], ref_atlas, 1e-4, "atlas")
    assert_rows_close(grads[0][0][:58], ref_rec[:58], 1e-3, "records")
    np.testing.assert_array_equal(grads[0][0], grads[1][0])
    np.testing.assert_array_equal(grads[0][1], grads[1][1])


def test_conversion_texture_gradient_matches_jax():
    """Mirror of tests/test_conversion.py::
    test_conversion_differentiable_wrt_texture, held against the JAX
    gradient: the loss's gradient reaches the source texture through the
    fragment VJP, the f32 tap gather and the atlas build."""
    mesh, mat = sphere_mesh(200, seed=6, tex=16)
    jm, jmat = jax_mesh_material(mesh, mat)
    cfg = dict(resolution=32, layers=4)

    def j_loss(tex):
        sp = JC.convert(jm, dataclasses.replace(jmat, base_color=tex),
                        *jm.bbox(), JC.ConversionConfig(**cfg))
        return jnp.sum(jnp.where(sp.valid[:, None], sp.color, 0.0) ** 2)

    ref = np.asarray(jax.grad(j_loss)(jnp.asarray(mat["base_color"])))
    j_valid = np.asarray(JC.convert(jm, jmat, *jm.bbox(),
                                    JC.ConversionConfig(**cfg)).valid)
    tm, tmat = torch_mesh_material(mesh, mat)
    tex = tmat.base_color.clone().requires_grad_(True)
    sp = TC.convert(tm, dataclasses.replace(tmat, base_color=tex),
                    *tm.bbox(), TC.ConversionConfig(**cfg))
    # the slot decisions stay exact with gradients enabled
    np.testing.assert_array_equal(sp.valid.numpy(), j_valid)
    (torch.where(sp.valid[:, None], sp.color, 0.0) ** 2).sum().backward()
    g = tex.grad.numpy()
    assert np.isfinite(g).all() and np.abs(g).sum() > 0
    np.testing.assert_allclose(g, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())

