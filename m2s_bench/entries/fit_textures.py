"""A texture fitter recovering an asset's base-colour map through the
conversion, as ``fit_textures`` does: one client runs the program's
``texture_step_fn`` step after step (the conversion from the map, the mean
L2 over the views of MESH2SPLAT ALBEDO renders, ``loss.backward()`` through
the renders, the fragment VJP and the tap atlas into the map,
``torch.optim.Adam`` and the clamp to [0, 1]), each step synchronised.

Set-up makes the asset from the seed and calibrates its conversion once.
The targets are ``render_rgb`` of the splats converted from the seed's true
maps, with the class-C pair budget that ``pair_budget`` gives them (no pair
dropped); the splats' geometry does not depend on the map, so the same
budget serves the steps. The start is the base-colour map flat at
``start`` in all four channels. Set-up builds the step (the map as a leaf,
Adam, ``texture_step_fn``) and drives it through its first
``first_steps`` steps, which are also the warm-up, reading each step's
loss, the map's first gradient and the map's change over them. The window
goes on with the same object. Every ``episode_steps`` steps of it (counted
from the start) the map is copied back from the start and Adam's state is
cleared, so that every run averages over the same cycle of steps.

Mix parameters: ``fixed_shape``, ``width``, ``height``, ``fov_deg``,
``eyes`` (one view each, looking at the origin with +y up), ``start``,
``lr``, ``first_steps``, ``episode_steps``, ``check_units`` (the window's
steps whose loss is checked to be finite, a sample drawn from the seed),
``ref_tile_batch`` (the tiles the reference's plain composite walks at a
time) and ``limits``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
import types

import numpy as np
import torch

from m2s_bench import harness, program
from m2s_bench.assets import asset_seed, synth_asset
from m2s_bench.reference import entry as ref
from m2s_bench.reference import texfit as RTX
from m2s_bench.reference.types import make_camera as ref_camera

# the asset's float tensors: what the control stores in bfloat16
ASSET_FLOATS = ("tri_pos", "tri_normal", "tri_tangent", "tri_uv",
                "base_color_factor", "base_color_tex", "normal_tex",
                "metallic_roughness_tex")


def make_inputs(run):
    """The run's asset, made from the seed. With ``fixed_shape`` every seed
    has the same shape (drawn from 0), so that every run converts the same
    geometry to the same slots; the maps come from the seed."""
    c = run.config
    run.inputs["asset"] = synth_asset(
        c["triangles"], c["texture_px"], asset_seed(run.seed, 0), run.device,
        shape_seed=0 if run.mix.get("fixed_shape") else None)


def limit_units(run):
    """The units the limits are read on: the window's first step (the
    numbers compared come from set-up's first steps)."""
    return [0]


def _cams(mix, device, make):
    return [make(list(e), [0.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                 np.deg2rad(mix["fov_deg"]), mix["width"], mix["height"],
                 device=device) for e in mix["eyes"]]


def _start(asset, value):
    return torch.full_like(asset["base_color_tex"], value)


def setup(run):
    from mesh2splat_torch.ops.conversion import (
        ConversionConfig, calibrate, convert,
    )
    from mesh2splat_torch.train import fit
    from mesh2splat_torch.train.fit import texture_step_fn
    from mesh2splat_torch.types import SplatFormat, make_camera

    c, mix = run.config, run.mix
    w, h = mix["width"], mix["height"]
    make_inputs(run)
    mesh, mat, _ = program.scene(run.inputs["asset"]).primitives[0]
    lo, hi = mesh.bbox()
    cfg = calibrate(mesh, lo, hi, ConversionConfig(
        resolution=c["resolution"], layers=c["layers"],
        gaussian_std=c["gaussian_std"]))
    mult = cfg.scale_multiplier
    cams = _cams(mix, run.device, make_camera)
    with torch.no_grad():
        true = convert(mesh, mat, lo, hi, cfg)
        budget = fit.pair_budget(true, cams, w, h,
                                 splat_format=SplatFormat.MESH2SPLAT,
                                 std_dev=mult)
        targets = torch.stack([
            fit.render_rgb(true, cam, w, h, std_dev=mult,
                           splat_format=SplatFormat.MESH2SPLAT,
                           pair_capacity=budget) for cam in cams])
    del true
    start = _start(run.inputs["asset"], mix["start"])
    tex = start.clone().requires_grad_(True)
    opt = torch.optim.Adam([tex], lr=mix["lr"], betas=fit.ADAM_BETAS,
                           eps=fit.ADAM_EPS)
    step = texture_step_fn(opt, tex, mesh, mat, cfg, (lo, hi), w, h,
                           pair_capacity=budget)
    state = {"tex": tex, "start": start, "opt": opt, "step": step,
             "cams": cams, "targets": targets, "mix": mix, "run": run}
    losses, grad = [], None
    for k in range(mix["first_steps"]):
        losses.append(float(step(cams, targets)))
        if k == 0:
            grad = tex.grad.detach().clone()
    run.readings = {"losses": losses, "grad": grad,
                    "change": tex.detach() - start, "pair_budget": budget}
    return state


def unit_key(state, i):
    """The step's place in its episode."""
    mix = state["mix"]
    return (mix["first_steps"] + i) % mix["episode_steps"]


def _restart(state):
    with torch.no_grad():
        state["tex"].copy_(state["start"])
    state["opt"].state.clear()


def unit(state, i):
    if unit_key(state, i) == 0:
        _restart(state)
    return state["step"](state["cams"], state["targets"])


def _ref_mesh(run):
    """The reference's mesh, material, bounds and calibrated config, made
    again from the asset."""
    c = run.config
    mesh, mat = ref.mesh_material(run.inputs["asset"])
    lo, hi = mesh.bbox()
    cfg = RTX.calibrated_config(mesh, lo, hi, c["resolution"], c["layers"],
                                c["gaussian_std"])
    return mesh, mat, lo, hi, cfg


def release(state):
    """After the window: the map's texels outside [0, 1], and the class-C
    pair need of the splats the window's map converts to (the reference's
    conversion and projection), against set-up's budget."""
    run, mix = state["run"], state["mix"]
    tex = state["tex"].detach()
    run.readings["tex_out_of_range"] = int(((tex < 0.0) | (tex > 1.0)).sum())
    mesh, mat, lo, hi, cfg = _ref_mesh(run)
    with torch.no_grad():
        splats = RTX.convert(mesh, dataclasses.replace(
            mat, base_color=tex.clone()), lo, hi, cfg)
    run.readings["pair_need"] = RTX.pair_need(
        splats, _cams(mix, run.device, ref_camera), mix["width"],
        mix["height"], cfg.scale_multiplier)
    harness.log(f"class-C pair need after the window "
                f"{run.readings['pair_need']}, budget "
                f"{run.readings['pair_budget']}")
    state.clear()


def _reference_steps(run, asset=None, unit=None):
    """The reference's targets and first steps from the start, on ``asset``
    (the run's own by default)."""
    mix = run.mix
    w, h = mix["width"], mix["height"]
    if asset is not None:
        run = types.SimpleNamespace(config=run.config,
                                    inputs={"asset": asset})
    mesh, mat, lo, hi, cfg = _ref_mesh(run)
    cams = _cams(mix, run.inputs["asset"]["tri_pos"].device, ref_camera)
    views, budget = RTX.targets(mesh, mat, lo, hi, cfg, cams, w, h,
                                mix["ref_tile_batch"])
    start = _start(run.inputs["asset"], mix["start"])
    kw = {} if unit is None else {"unit": unit}
    return RTX.first_steps(mesh, mat, lo, hi, cfg, start, cams, views, w, h,
                           budget, mix["lr"], mix["first_steps"],
                           mix["ref_tile_batch"], **kw)


def reference_readings(run) -> dict:
    """The reference's first steps from the same start (kept in
    ``run.inputs``, so that runs of one seed read them once)."""
    if "reference_readings" not in run.inputs:
        t0 = time.perf_counter()
        run.inputs["reference_readings"] = _reference_steps(
            run, unit=run.reference_unit)
        harness.log(f"reference: targets and {run.mix['first_steps']} "
                    f"steps in {time.perf_counter() - t0:.1f} s")
    return run.inputs["reference_readings"]


def _rel(a, b) -> float:
    """||a - b|| / ||b||, in float64."""
    d = float(torch.linalg.vector_norm((a.double() - b.double())))
    n = float(torch.linalg.vector_norm(b.double()))
    if n > 0.0:
        return d / n
    return 0.0 if d == 0.0 else math.inf


def texfit_readings(prog: dict, want: dict) -> dict:
    """First steps against the reference's:
    loss_rel_err: the largest |loss - reference's| / reference's over the
    steps;
    tex_grad_rel_err: ||g - g_ref|| / ||g_ref|| of the first gradient over
    the map's texels and channels;
    tex_change_rel_err: the same of the map's change over the steps."""
    if len(prog["losses"]) != len(want["losses"]):
        loss = math.inf
    else:
        loss = max(abs(a - b) / abs(b) if b else
                   (0.0 if a == b else math.inf)
                   for a, b in zip(prog["losses"], want["losses"]))
    return {"loss_rel_err": loss,
            "tex_grad_rel_err": _rel(prog["grad"], want["grad"]),
            "tex_change_rel_err": _rel(prog["change"], want["change"])}


def check(run, samples):
    """Set-up's first steps against the reference's (each step's loss, the
    map's first gradient and its change), the window's pair need within
    its budget, the window's sampled steps' losses finite and its map in
    [0, 1]. When any but the sampled losses fail, every sampled step,
    which follows from them, counts as failed."""
    limits = run.mix["limits"]
    got = texfit_readings(run.readings, reference_readings(run))
    got["pair_need_per_budget"] = (run.readings["pair_need"]
                                   / run.readings["pair_budget"])
    got["losses_not_finite"] = sum(not math.isfinite(float(loss))
                                   for _, loss in samples)
    got["tex_out_of_range"] = run.readings["tex_out_of_range"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in got.items()}
    if any(not c["value"] <= c["limit"] for k, c in checks.items()
           if k != "losses_not_finite"):
        return checks, len(samples)
    return checks, got["losses_not_finite"]


def control(run, units):
    """The control's readings: the reference's first steps on the asset
    stored in bfloat16 (its geometry and maps; the start is 0.5 either
    way), against the reference's on the asset."""
    want = _reference_steps(run)
    low = dict(run.inputs["asset"])
    for k in ASSET_FLOATS:
        low[k] = low[k].to(torch.bfloat16).float()
    return texfit_readings(_reference_steps(run, asset=low), want)


def _unchanged(fit, fragment):
    """The step leaves the map as it was: Adam never steps."""
    orig = fit.texture_step_fn

    def texture_step_fn(optimizer, *a, **kw):
        frozen = types.SimpleNamespace(zero_grad=optimizer.zero_grad,
                                       step=lambda: None)
        return orig(frozen, *a, **kw)
    return fit, "texture_step_fn", texture_step_fn


def _half_batch(fit, fragment):
    """Half of the views left out, the mean taken over the rest."""
    orig = fit.mean_l2

    def mean_l2(splats, cameras, targets, *a, **kw):
        n = max(len(cameras) // 2, 1)
        return orig(splats, cameras[:n], targets[:n], *a, **kw)
    return fit, "mean_l2", mean_l2


def _tex_grad_scaled(fit, fragment):
    """The map's gradient altered where it is made: x 1.5."""
    orig = fit.texture_step_fn

    def texture_step_fn(optimizer, tex, *a, **kw):
        tex.register_hook(lambda g: g * 1.5)
        return orig(optimizer, tex, *a, **kw)
    return fit, "texture_step_fn", texture_step_fn


def _tap_dropped(fit, fragment):
    """The fragment VJP drops the gradient of one of each texel's four
    bilinear taps (the atlas's fields are k texels x 4 taps x 10
    channels a row; tap 1 is the right-hand neighbour)."""
    orig = fragment._FragmentApply.backward

    def backward(ctx, g_out):
        d_rec, d_taps, *rest = orig(ctx, g_out)
        if d_taps is not None:
            d_taps = d_taps.clone()
            d_taps.view(-1, 4, fragment.TAPS_C, d_taps.shape[1])[:, 1] = 0.0
        return (d_rec, d_taps, *rest)
    return fragment._FragmentApply, "backward", staticmethod(backward)


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch,
          "tex_grad_scaled": _tex_grad_scaled, "tap_dropped": _tap_dropped}


@contextlib.contextmanager
def planted(name):
    """The program's texture fitter with the fault ``name`` planted
    underneath the timed path (CPU tests, and limits.py's fault
    readings)."""
    from mesh2splat_torch.ops import fragment
    from mesh2splat_torch.train import fit

    obj, attr, fn = FAULTS[name](fit, fragment)
    orig = obj.__dict__[attr]
    setattr(obj, attr, fn)
    try:
        yield
    finally:
        setattr(obj, attr, orig)
