"""Training in mesh2splat_torch against mesh2splat_tpu on the CPU: the L2
loss and its gradients over a batch of views, fit_splats' loss history
over 15 Adam steps, fit_textures' history and first gradient through
conversion, and a checkpoint round trip.

Two scenes. The single-device setup of tests/test_sharding.py (a quad of
64 opaque white splats on 16x16 views, black targets) saturates every
pixel: there only the colour gradient is more than rounding (the pos,
scale, quat and opacity gradients are below 2e-6 against the colour's 0.4,
in JAX as in the port, from the 1 / (1 - min(alpha g, 0.9999)) of the
suffix trick), so its gradients are held to 1e-3 of the loss's largest
gradient and its history only to the JAX test's assertion (Adam turns
rounding-level gradients into full steps). The well-conditioned scene
(random splats from a noise-coloured start towards a rendered target, two
64x64 views) holds every parameter's gradient to 1e-3 of its own largest
magnitude (the composite VJP's order of summation, as in
tests/test_torch_backward.py; measured 5e-5) and the 15-step history to
rtol 1e-4 (measured 8e-6). The loss agrees to rtol 1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mesh2splat_tpu.ops.conversion import ConversionConfig as JCfg
from mesh2splat_tpu.ops.conversion import convert as j_convert
from mesh2splat_tpu.train import fit as JFIT
from mesh2splat_tpu.types import Material as JMaterial
from mesh2splat_tpu.types import SplatFormat as JSF
from mesh2splat_tpu.types import Splats as JSplats
from mesh2splat_tpu.types import TriangleMesh as JMesh
from mesh2splat_tpu.types import make_camera as j_camera

from mesh2splat_torch import state
from mesh2splat_torch.ops import conversion as TC
from mesh2splat_torch.ops.projection import project_splats
from mesh2splat_torch.render.binning import required_overflow
from mesh2splat_torch.render.tiled import rasterize_tiled
from mesh2splat_torch.train import fit as TFIT
from mesh2splat_torch.types import SplatFormat as TSF
from mesh2splat_torch.types import make_camera
from mesh2splat_torch.utils import checkpoint
from test_torch_backward import random_splats
from torch_parity import host



@pytest.fixture(autouse=True)
def one_torch_thread():
    """These tests loop over many small torch ops: one thread each keeps
    them from contending with the suite's other workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def quad_mesh():
    """tests/test_sharding.py quad_mesh, as numpy."""
    v = np.array([[-0.5, -0.5, 0], [0.5, -0.5, 0], [0.5, 0.5, 0],
                  [-0.5, 0.5, 0]], np.float32)
    tris = np.array([[0, 1, 2], [0, 2, 3]])
    return dict(
        tri_pos=v[tris],
        tri_normal=np.broadcast_to([0, 0, 1.0], (2, 3, 3)).astype(np.float32),
        tri_tangent=np.broadcast_to([1, 0, 0, 1.0], (2, 3, 4))
        .astype(np.float32),
        tri_uv=(v[tris][..., :2] + 0.5).astype(np.float32),
    )


def j_mesh(m):
    return JMesh(**{k: jnp.asarray(v) for k, v in m.items()})


def stacked(cams):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *cams)


def quad_splats(res=8):
    mesh = j_mesh(quad_mesh())
    cfg = JCfg(resolution=res, layers=2)
    return j_convert(mesh, JMaterial.default(), *mesh.bbox(), cfg), cfg


def assert_close_scaled(got, ref, rel, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rel,
                               atol=rel * max(np.abs(ref).max(), 1e-30),
                               err_msg=what)


def sharding_scene():
    """tests/test_sharding.py's single-device step: 8 views of 16x16 of
    the converted quad, black targets."""
    splats, cfg = quad_splats()
    cams = stacked([
        j_camera(eye=[np.sin(a), 0.2, 1.5 + 0.1 * np.cos(a)],
                 center=[0, 0, 0], up=[0, 1, 0], fov_y_rad=np.pi / 3,
                 width=16, height=16)
        for a in np.linspace(0, 1, 8)])
    return (splats, cams, np.zeros((8, 16, 16, 3), np.float32), 16,
            cfg.scale_multiplier)


def random_scene():
    """30 random splats rendered from two 64x64 views as the targets; the
    start has the same splats with colours from numpy uniform noise."""
    sp = random_splats(30, 4, alpha_max=0.9)
    cams = stacked([j_camera(eye=eye, center=[0, 0, 0], up=[0, 1, 0],
                             fov_y_rad=np.pi / 3, width=64, height=64)
                    for eye in ([0, 0, 4], [0.8, 0.4, 3.5])])
    ref = JSplats(**{k: jnp.asarray(v) for k, v in sp.items()})
    targets = np.asarray(jax.vmap(
        lambda c: JFIT.render_rgb(ref, c, 64, 64))(cams))
    noise = np.random.default_rng(0).uniform(0, 1, (30, 3))
    sp["color"] = np.concatenate([noise, sp["color"][:, 3:]], 1) \
        .astype(np.float32)
    start = JSplats(**{k: jnp.asarray(v) for k, v in sp.items()})
    return start, cams, targets, 64, 1.0


@pytest.mark.parametrize("scene", ["sharding", "random"])
def test_l2_loss_and_gradients_match_jax(scene):
    """The port's loss and every parameter's gradient against
    jax.value_and_grad of the JAX l2_loss on the same params (parameters
    that the albedo render does not reach get no gradient in the port and
    zero in JAX)."""
    splats, cams, targets, size, std = (sharding_scene if scene == "sharding"
                                        else random_scene)()
    params = JFIT.SplatParams.from_splats(splats)
    loss, grads = jax.value_and_grad(JFIT.l2_loss)(
        params, splats.valid, cams, jnp.asarray(targets), size, size,
        std_dev=std)

    tparams = state.splat_params(host(params), "cpu")
    valid = torch.from_numpy(np.array(splats.valid))
    tloss = TFIT.l2_loss(tparams, valid, state.cameras(cams, "cpu"),
                         torch.from_numpy(targets), size, size, std_dev=std)
    tloss.backward()
    assert float(loss) > 0
    np.testing.assert_allclose(float(tloss.detach()), float(loss), rtol=1e-5)
    ref = host(grads)
    got = {k: (v.grad.numpy() if v.grad is not None
               else np.zeros_like(ref[k]))
           for k, v in tparams.as_dict().items()}
    assert not ref["normal"].any() and not ref["pbr"].any()
    largest = max(np.abs(g).max() for g in ref.values())
    for name in got:
        scale = largest if scene == "sharding" else np.abs(ref[name]).max()
        np.testing.assert_allclose(got[name], ref[name], rtol=1e-3,
                                   atol=1e-3 * scale, err_msg=name)


def test_fit_splats_history_matches_jax():
    """tests/test_sharding.py::test_fit_splats_reduces_loss's assertion on
    the port's 15 steps, and the port's history against the JAX
    fit_splats' on the well-conditioned scene."""
    splats, cfg = quad_splats()
    cams = stacked([j_camera(eye=[0, 0, 2], center=[0, 0, 0], up=[0, 1, 0],
                             fov_y_rad=np.pi / 3, width=16, height=16)])
    fitted, hist = TFIT.fit_splats(
        state.splats(host(splats), "cpu"), state.cameras(cams, "cpu"),
        np.zeros((1, 16, 16, 3), np.float32),
        TFIT.FitConfig(steps=15, lr=5e-2, width=16, height=16,
                       std_dev=cfg.scale_multiplier), device="cpu")
    assert hist[-1] < hist[0] * 0.7, hist
    assert fitted.pos.shape == splats.pos.shape and not fitted.pos.requires_grad

    start, cams, targets, size, _ = random_scene()
    fit_cfg = dict(steps=15, lr=1e-2, width=size, height=size)
    _, ref = JFIT.fit_splats(start, cams, jnp.asarray(targets),
                             JFIT.FitConfig(**fit_cfg))
    _, hist = TFIT.fit_splats(state.splats(host(start), "cpu"),
                              state.cameras(cams, "cpu"), targets,
                              TFIT.FitConfig(**fit_cfg), device="cpu")
    assert hist[-1] < 0.5 * hist[0]
    np.testing.assert_allclose(hist, ref, rtol=1e-4)


def test_fit_splats_budget_covers_the_loss_render():
    """fit_splats' class-C pair budget comes from the projection l2_loss
    renders (PLY_3DGS, where std_dev has no effect): it covers each view's
    need and the render at that budget drops no pair. A budget projected
    with std_dev = 1/64 in MESH2SPLAT, as the JAX fit_splats sizes it,
    falls short of the same need."""
    sp = state.splats(random_splats(2000, seed=5), "cpu")
    cams = [make_camera(eye, [0, 0, 0], [0, 1, 0], np.pi / 3, 256, 256,
                        device="cpu") for eye in ([0, 0, 4], [0.8, 0.4, 3.5])]
    budget = TFIT.pair_budget(sp, cams, 256, 256)
    need = [int(required_overflow(project_splats(
        sp, c, splat_format=TSF.PLY_3DGS), 256, 256)) for c in cams]
    small = [int(required_overflow(project_splats(sp, c, std_dev=1 / 64),
                                   256, 256)) for c in cams]
    assert max(small) < max(need) <= budget
    out = rasterize_tiled(project_splats(sp, cams[1],
                                         splat_format=TSF.PLY_3DGS),
                          256, 256, albedo_only=True, pair_capacity=budget)
    assert int(out["dropped_pairs"]) == 0


def _two_tone():
    tex = np.full((8, 8, 4), 1.0, np.float32)
    tex[:, :4, :3] = [0.9, 0.1, 0.1]
    tex[:, 4:, :3] = [0.1, 0.2, 0.8]
    return tex


def _texture_setup():
    """tests/test_fit_textures.py's quad, two-tone target texture, two
    32x32 views and flat grey start."""
    mesh = quad_mesh()
    cams = stacked([
        j_camera(eye=[0, 0, 1.6], center=[0, 0, 0], up=[0, 1, 0],
                 fov_y_rad=np.pi / 3, width=32, height=32),
        j_camera(eye=[0.4, 0.2, 1.5], center=[0, 0, 0], up=[0, 1, 0],
                 fov_y_rad=np.pi / 3, width=32, height=32)])
    cfg = JCfg(resolution=16, layers=2)
    jm = j_mesh(mesh)
    mat_gt = dataclasses.replace(JMaterial.default(),
                                 base_color=jnp.asarray(_two_tone()),
                                 has_base_color=True)
    sp_gt = j_convert(jm, mat_gt, *jm.bbox(), cfg)
    targets = np.asarray(jax.vmap(lambda c: JFIT.render_rgb(
        sp_gt, c, 32, 32, std_dev=cfg.scale_multiplier,
        splat_format=JSF.MESH2SPLAT))(cams))
    mat0 = dataclasses.replace(JMaterial.default(),
                               base_color=jnp.full((8, 8, 4), 0.5),
                               has_base_color=True)
    return mesh, jm, mat0, cfg, cams, targets


def test_fit_textures_matches_jax():
    """tests/test_fit_textures.py's assertions on the port (40 steps), its
    history against the JAX fit_textures', and the first step's texture
    gradient against jax.grad."""
    mesh, jm, mat0, cfg, cams, targets = _texture_setup()
    tcfg = TC.ConversionConfig(resolution=16, layers=2)
    tmesh = state.mesh(mesh, "cpu")
    tmat0 = state.material(host(mat0), "cpu")
    tcams = state.cameras(cams, "cpu")

    def j_loss(tex):
        sp = j_convert(jm, dataclasses.replace(mat0, base_color=tex),
                       *jm.bbox(), cfg)
        return jnp.mean(jax.vmap(lambda c, t: jnp.mean((JFIT.render_rgb(
            sp, c, 32, 32, std_dev=cfg.scale_multiplier,
            splat_format=JSF.MESH2SPLAT) - t) ** 2))(cams,
                                                     jnp.asarray(targets)))

    ref_g = np.asarray(jax.grad(j_loss)(mat0.base_color))
    tex = tmat0.base_color.clone().requires_grad_(True)
    sp = TC.convert(tmesh, dataclasses.replace(tmat0, base_color=tex),
                    *tmesh.bbox(), tcfg)
    torch.stack([torch.mean((TFIT.render_rgb(
        sp, c, 32, 32, std_dev=tcfg.scale_multiplier,
        splat_format=TSF.MESH2SPLAT) - torch.from_numpy(t.copy())) ** 2)
        for c, t in zip(tcams, targets)]).mean().backward()
    assert np.abs(ref_g).max() > 0
    assert_close_scaled(tex.grad.numpy(), ref_g, 1e-3, "texture gradient")

    fit_cfg = dict(steps=40, lr=8e-2, width=32, height=32)
    _, ref_hist = JFIT.fit_textures(jm, mat0, cfg, cams,
                                    jnp.asarray(targets),
                                    JFIT.FitTexturesConfig(**fit_cfg))
    fitted, hist = TFIT.fit_textures(tmesh, tmat0, tcfg, tcams, targets,
                                     TFIT.FitTexturesConfig(**fit_cfg),
                                     device="cpu")
    assert np.isfinite(hist).all()
    assert hist[-1] < 0.5 * hist[0], f"loss {hist[0]} -> {hist[-1]}"
    ft = fitted.base_color.numpy()
    assert ft[4, 1, 0] > 0.6 and ft[4, 1, 2] < 0.4     # red half
    assert ft[4, 6, 2] > 0.5 and ft[4, 6, 0] < 0.4     # blue half
    np.testing.assert_allclose(hist, ref_hist, rtol=1e-3)


def test_checkpoint_round_trip(tmp_path):
    """Params, Adam state and step survive save/load; a step after the load
    equals a step without the round trip."""
    rng = np.random.default_rng(0)
    n = 6
    src = dict(pos=rng.normal(size=(n, 3)), color=rng.uniform(size=(n, 3)),
               opacity_logit=rng.normal(size=(n,)),
               log_scale=rng.normal(size=(n, 3)),
               quat=rng.normal(size=(n, 4)), normal=rng.normal(size=(n, 3)),
               pbr=rng.uniform(size=(n, 2)))
    src = {k: v.astype(np.float32) for k, v in src.items()}

    def setup():
        p = state.splat_params(src, "cpu")
        return p, torch.optim.Adam(p.parameters(), lr=1e-2)

    def step(p, opt):
        opt.zero_grad()
        sum((t ** 2).sum() for t in p.parameters()).backward()
        opt.step()

    p, opt = setup()
    for _ in range(3):
        step(p, opt)
    checkpoint.save_training_state(tmp_path / "ck" / "state.pt", p, opt, 3)
    q, opt_q = setup()
    q, opt_q, n_step = checkpoint.load_training_state(
        tmp_path / "ck" / "state.pt", q, opt_q)
    assert n_step == 3
    for a, b in zip(p.parameters(), q.parameters()):
        assert torch.equal(a, b)
    step(p, opt)
    step(q, opt_q)
    out_p, out_q = state.params_to_numpy(p), state.params_to_numpy(q)
    for k in out_p:
        np.testing.assert_array_equal(out_q[k], out_p[k])


def test_parallel_options_raise():
    """Data-parallel training (devices_mesh= / mesh=) belongs to the port's
    parallel slice: asking for it raises and names that slice."""
    splats, cfg = quad_splats()
    cams = state.cameras(stacked([j_camera(
        eye=[0, 0, 2], center=[0, 0, 0], up=[0, 1, 0], fov_y_rad=np.pi / 3,
        width=16, height=16)]), "cpu")
    with pytest.raises(NotImplementedError, match="parallel"):
        TFIT.fit_splats(state.splats(host(splats), "cpu"), cams,
                        np.zeros((1, 16, 16, 3), np.float32),
                        TFIT.FitConfig(steps=1, width=16, height=16),
                        devices_mesh=object(), device="cpu")
    params = state.splat_params(host(JFIT.SplatParams.from_splats(splats)),
                                "cpu")
    with pytest.raises(NotImplementedError, match="parallel"):
        TFIT.train_step_fn(torch.optim.Adam(params.parameters()), 16, 16,
                           mesh=object())
