"""The texture fitter's step (``train.fit.texture_step_fn``) on the CPU at a
small size: against the benchmark's plain reference
(``m2s_bench/reference/texfit.py``, plain autograd through the frozen
conversion and render), ``fit_textures`` built on it giving the history
of the loop it replaced, and the class-C pair budget it sizes for the way
it renders.

The step and the reference agree to rounding: on the CPU the fragment
VJP's recomputation is autograd's own arithmetic (the gradient agrees bit
for bit, measured), and the two Adams round differently (``lerp_`` against
``mul_`` and ``add_``; the change measured 6e-8 relative)."""

import dataclasses
import pathlib
import subprocess
import sys

import pytest
import torch

from m2s_bench import program
from m2s_bench.assets import synth_asset
from m2s_bench.reference import entry as ref_entry
from m2s_bench.reference import texfit as RTX
from m2s_bench.reference.types import make_camera as ref_camera
from mesh2splat_torch.ops import conversion as TC
from mesh2splat_torch.render import binning
from mesh2splat_torch.train import fit
from mesh2splat_torch.types import SplatFormat, make_camera

ROOT = pathlib.Path(__file__).resolve().parents[1]
W = H = 48
EYES = ([0.0, 0.0, 3.2], [0.8, 0.4, 3.0])
LR = 5e-2


@pytest.fixture(autouse=True)
def few_torch_threads():
    """Many small ops a step: two threads a test keep the suite's workers
    from contending for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cams(make):
    return [make(e, [0.0, 0.0, 0.0], [0.0, 1.0, 0.0], 1.0, W, H,
                 device="cpu") for e in EYES]


@pytest.fixture(scope="module")
def asset():
    """A 450-triangle sphere with seeded random 32^2 maps."""
    return synth_asset(450, 32, seed=11, device="cpu", shape_seed=0)


def _program_problem(asset):
    mesh, mat, _ = program.scene(asset).primitives[0]
    lo, hi = mesh.bbox()
    cfg = TC.calibrate(mesh, lo, hi, TC.ConversionConfig(resolution=48,
                                                         layers=4))
    return mesh, mat, lo, hi, cfg


def _targets(mesh, mat, lo, hi, cfg, cams, budget):
    with torch.no_grad():
        true = TC.convert(mesh, mat, lo, hi, cfg)
        return torch.stack([fit.render_rgb(
            true, c, W, H, std_dev=cfg.scale_multiplier,
            splat_format=SplatFormat.MESH2SPLAT, pair_capacity=budget)
            for c in cams])


def _rel(a, b):
    return float(torch.linalg.vector_norm((a - b).double())
                 / torch.linalg.vector_norm(b.double()))


def test_texture_step_matches_the_reference(asset):
    """Two steps from a seeded random start map: each step's loss, the
    first gradient of the map and the map's change over the steps."""
    g = torch.Generator().manual_seed(5)
    start = torch.rand(asset["base_color_tex"].shape, generator=g)
    mesh, mat, lo, hi, cfg = _program_problem(asset)
    cams = _cams(make_camera)
    with torch.no_grad():
        budget = fit.pair_budget(TC.convert(mesh, mat, lo, hi, cfg), cams, W,
                                 H, splat_format=SplatFormat.MESH2SPLAT,
                                 std_dev=cfg.scale_multiplier)
    targets = _targets(mesh, mat, lo, hi, cfg, cams, budget)
    tex = start.clone().requires_grad_(True)
    opt = torch.optim.Adam([tex], lr=LR, betas=fit.ADAM_BETAS,
                           eps=fit.ADAM_EPS)
    step = fit.texture_step_fn(opt, tex, mesh, mat, cfg, (lo, hi), W, H,
                               pair_capacity=budget)
    losses = [float(step(cams, targets))]
    grad = tex.grad.clone()
    losses.append(float(step(cams, targets)))
    assert bool(((tex >= 0.0) & (tex <= 1.0)).all())

    rmesh, rmat = ref_entry.mesh_material(asset)
    rlo, rhi = rmesh.bbox()
    rcfg = RTX.calibrated_config(rmesh, rlo, rhi, 48, 4, 1.0)
    assert rcfg.capacity == cfg.capacity
    rcams = _cams(ref_camera)
    views, rbudget = RTX.targets(rmesh, rmat, rlo, rhi, rcfg, rcams, W, H,
                                 tile_batch=64)
    assert rbudget == budget
    torch.testing.assert_close(views, targets, rtol=0, atol=1e-6)
    want = RTX.first_steps(rmesh, rmat, rlo, rhi, rcfg, start, rcams, views,
                           W, H, rbudget, LR, 2, tile_batch=64)
    assert float(torch.linalg.vector_norm(want["grad"])) > 0.0
    torch.testing.assert_close(losses, want["losses"], rtol=1e-6, atol=0)
    assert _rel(grad, want["grad"]) <= 1e-6
    assert _rel(tex.detach() - start, want["change"]) <= 1e-6


def _loop_before(mesh, material, cfg, cams, targets, steps, lr):
    """fit_textures' loop as it was written before it was built on
    texture_step_fn: the step inline, the binner's default class-C
    budget."""
    lo, hi = mesh.bbox()
    tex = material.base_color.detach().clone().requires_grad_(True)
    opt = torch.optim.Adam([tex], lr=lr, betas=fit.ADAM_BETAS,
                           eps=fit.ADAM_EPS)
    history = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        mat = dataclasses.replace(material, base_color=tex,
                                  has_base_color=True)
        splats = TC.convert(mesh, mat, lo, hi, cfg)
        loss = torch.stack([
            torch.mean((fit.render_rgb(splats, c, W, H,
                                       std_dev=cfg.scale_multiplier,
                                       splat_format=SplatFormat.MESH2SPLAT)
                        - t) ** 2) for c, t in zip(cams, targets)]).mean()
        loss.backward()
        opt.step()
        with torch.no_grad():
            tex.clamp_(0.0, 1.0)
        history.append(float(loss.detach()))
    return tex.detach(), history


def test_fit_textures_history_as_before(asset):
    mesh, mat, lo, hi, cfg = _program_problem(asset)
    cams = _cams(make_camera)
    targets = _targets(mesh, mat, lo, hi, cfg, cams, 0)
    grey = dataclasses.replace(mat, base_color=torch.full_like(
        mat.base_color, 0.5))
    want_tex, want = _loop_before(mesh, grey, cfg, cams, targets, 3, LR)
    fitted, hist = fit.fit_textures(
        mesh, grey, cfg, cams, targets,
        fit.FitTexturesConfig(steps=3, lr=LR, width=W, height=H),
        device="cpu")
    assert hist == want
    assert torch.equal(fitted.base_color, want_tex)


def test_texture_budget_covers_the_renders(asset, monkeypatch):
    """fit_textures sizes its class-C budget in MESH2SPLAT with the
    conversion's sigma, as it renders: every render of its steps drops no
    pair and is given that budget. The PLY_3DGS budget (the trainer's,
    which reads the converted scales as world units) is another."""
    mesh, mat, lo, hi, cfg = _program_problem(asset)
    cams = _cams(make_camera)
    targets = _targets(mesh, mat, lo, hi, cfg, cams, 0)
    with torch.no_grad():
        splats = TC.convert(mesh, mat, lo, hi, cfg)
    budget = fit.pair_budget(splats, cams, W, H,
                             splat_format=SplatFormat.MESH2SPLAT,
                             std_dev=cfg.scale_multiplier)
    assert budget != fit.pair_budget(splats, cams, W, H)
    seen = []
    orig = binning.bin_pairs

    def spy(proj, width, height, c_capacity=0, **kw):
        out = orig(proj, width, height, c_capacity, **kw)
        seen.append((c_capacity, int(out.dropped_pairs)))
        return out

    monkeypatch.setattr(binning, "bin_pairs", spy)
    fit.fit_textures(mesh, mat, cfg, cams, targets,
                     fit.FitTexturesConfig(steps=2, lr=LR, width=W,
                                           height=H), device="cpu")
    assert seen == [(budget, 0)] * 4


def test_reference_imports_nothing_of_the_program():
    p = subprocess.run(
        [sys.executable, "-c",
         f"import sys; sys.path.insert(0, {str(ROOT)!r})\n"
         "import m2s_bench.reference.texfit\n"
         "print(' '.join(sorted(sys.modules)))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    tops = {m.split(".")[0] for m in p.stdout.split()}
    assert "m2s_bench" in tops and "torch" in tops
    assert not tops & {"mesh2splat_torch", "mesh2splat_tpu", "jax",
                       "jaxlib", "flax"}
