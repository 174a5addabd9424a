"""A trainer refining the asset's converted splats by Adam against target
renders, as ``fit_splats`` does: one client runs the program's
``train_step_fn`` step after step (the mean L2 over the views,
``loss.backward()``, ``torch.optim.Adam`` over the seven ``SplatParams``
leaves), each step synchronised.

Set-up converts the asset (``Scene.convert``, as the orbit cells do) and
makes the start: the splats in world units as the loss renders them
(SplatFormat.PLY_3DGS: scales times the conversion's sigma, as
``export_ply`` writes them) with colours of uniform noise drawn from the
seed. The targets are ``render_rgb`` of the converted splats; the class-C
pair budget is ``pair_budget`` of the start. Set-up then builds the step
(``SplatParams``, Adam, ``train_step_fn``) and drives it through its first
``first_steps`` steps, which are also the warm-up, reading each step's loss,
the norm of each leaf's first gradient (from Adam's first moment after one
step) and the norm of each leaf's change over them. The window goes on with
the same object. Every ``episode_steps`` steps of it (counted from the
start) the leaves are copied back from the start and Adam's state is
cleared, so that every run averages over the same cycle of steps and the
budget keeps covering the renders.

Mix parameters: ``fixed_shape``, ``width``, ``height``, ``fov_deg``,
``eyes`` (one view each, looking at the origin with +y up), ``lr``,
``first_steps``, ``episode_steps``, ``check_units`` (the window's steps
whose loss is checked to be finite, a sample drawn from the seed),
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

from m2s_bench import compare, harness, program
from m2s_bench.assets import asset_seed, synth_asset
from m2s_bench.reference import entry as ref
from m2s_bench.reference import train as RT
from m2s_bench.reference.render import binning as RB
from m2s_bench.reference.types import make_camera as ref_camera


def make_inputs(run):
    """The run's asset and the start's colour noise, made from the seed;
    the noise has a row for every slot the conversion can fill. With
    ``fixed_shape`` every seed has the same shape (drawn from 0), so that
    every run starts from the same splats' geometry and sizes."""
    c = run.config
    run.inputs["asset"] = synth_asset(
        c["triangles"], c["texture_px"], asset_seed(run.seed, 0), run.device,
        shape_seed=0 if run.mix.get("fixed_shape") else None)
    g = torch.Generator(device=run.device)
    g.manual_seed(asset_seed(run.seed, 1))
    run.inputs["noise"] = torch.rand(
        (c["resolution"] ** 2 * c["layers"], 3), generator=g,
        device=run.device)


def limit_units(run):
    """The units the limits are read on: the window's first step (the
    numbers compared come from set-up's first steps)."""
    return [0]


def _with_noise(splats, noise):
    return dataclasses.replace(splats, color=torch.cat(
        [noise[:splats.capacity].to(splats.color.device),
         splats.color[:, 3:]], 1))


def _first_gradient_norms(opt, params) -> list:
    """Each leaf's first gradient as Adam got it: its first moment after
    one step over (1 - beta1); 0 for a leaf Adam has no state of."""
    b1 = opt.defaults["betas"][0]
    out = []
    for p in params.parameters():
        st = opt.state.get(p, {})
        m = st.get("exp_avg")
        out.append(0.0 if m is None else
                   float(torch.linalg.vector_norm(m.double())) / (1.0 - b1))
    return out


def setup(run):
    from mesh2splat_torch.train import fit
    from mesh2splat_torch.types import make_camera

    c, mix = run.config, run.mix
    w, h = mix["width"], mix["height"]
    make_inputs(run)
    scene = program.scene(run.inputs["asset"])
    sp = scene.convert(resolution=c["resolution"], layers=c["layers"],
                       gaussian_std=c["gaussian_std"],
                       calibrated=c["calibrated"])
    mult = scene.last_config.scale_multiplier
    real = dataclasses.replace(sp, scale=sp.scale * mult)
    cams = [make_camera(list(e), [0.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                        np.deg2rad(mix["fov_deg"]), w, h, device=run.device)
            for e in mix["eyes"]]
    with torch.no_grad():
        targets = torch.stack([fit.render_rgb(real, cam, w, h)
                               for cam in cams])
    start = _with_noise(real, run.inputs["noise"])
    del sp, real
    params = fit.SplatParams.from_splats(start)
    opt = torch.optim.Adam(params.parameters(), lr=mix["lr"],
                           betas=fit.ADAM_BETAS, eps=fit.ADAM_EPS)
    budget = fit.pair_budget(start, cams, w, h)
    step = fit.train_step_fn(opt, w, h, std_dev=mult, pair_capacity=budget)
    state = {"params": params, "valid": start.valid, "cams": cams,
             "targets": targets, "opt": opt, "step": step, "mix": mix,
             "start": [p.detach().clone() for p in params.parameters()],
             "run": run}
    del start
    losses, grad_norms = [], None
    for k in range(mix["first_steps"]):
        losses.append(float(step(params, state["valid"], cams, targets)))
        if k == 0:
            grad_norms = _first_gradient_norms(opt, params)
    run.readings = {
        "losses": losses, "grad_norms": grad_norms,
        "change_norms": RT.norms(p.detach() - s for p, s in
                                 zip(params.parameters(), state["start"])),
        "pair_budget": budget}
    return state


def unit_key(state, i):
    """The step's place in its episode."""
    mix = state["mix"]
    return (mix["first_steps"] + i) % mix["episode_steps"]


def _restart(state):
    with torch.no_grad():
        for p, s in zip(state["params"].parameters(), state["start"]):
            p.copy_(s)
    state["opt"].state.clear()


def unit(state, i):
    if unit_key(state, i) == 0:
        _restart(state)
    return state["step"](state["params"], state["valid"], state["cams"],
                         state["targets"])


def release(state):
    """After the window: the class-C pair need of the splats the window
    left, against set-up's budget."""
    run, mix = state["run"], state["mix"]
    p = {k: v.detach() for k, v in state["params"].as_dict().items()}
    cams = [_ref_cam(mix, e, run.device) for e in mix["eyes"]]
    run.readings["pair_need"] = RT.pair_need(
        RT.to_splats(p, state["valid"]), cams, mix["width"], mix["height"])
    harness.log(f"class-C pair need after the window "
                f"{run.readings['pair_need']}, budget "
                f"{run.readings['pair_budget']}")
    state.clear()


def _ref_cam(mix, eye, device):
    return ref_camera(list(eye), [0.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                      np.deg2rad(mix["fov_deg"]), mix["width"],
                      mix["height"], device=device)


def _ref_start(run):
    """The reference's start, views and targets, made again from the
    asset and the noise."""
    c, mix = run.config, run.mix
    w, h = mix["width"], mix["height"]
    splats, cfg = ref.convert(run.inputs["asset"], c["resolution"],
                              c["layers"], c["gaussian_std"],
                              c["calibrated"])
    mult = cfg.scale_multiplier
    real = dataclasses.replace(splats, scale=splats.scale * mult)
    cams = [_ref_cam(mix, e, run.device) for e in mix["eyes"]]
    with torch.no_grad():
        targets = torch.stack([
            RT.render_rgb(real, cam, w, h, 1.0, 0, mix["ref_tile_batch"])
            for cam in cams])
    return _with_noise(real, run.inputs["noise"]), cams, targets, mult


def _reference_steps(run, start, cams, targets, mult, unit=None):
    mix = run.mix
    w, h = mix["width"], mix["height"]
    budget = RB.round_pow2_budget(RT.pair_need(start, cams, w, h))
    kw = {} if unit is None else {"unit": unit}
    return RT.first_steps(RT.leaves_from_splats(start), start.valid, cams,
                          targets, w, h, mult, budget, mix["lr"],
                          mix["first_steps"], mix["ref_tile_batch"], **kw)


def reference_readings(run) -> dict:
    """The reference's first steps from the same start (kept in
    ``run.inputs``, so that runs of one seed read them once)."""
    if "reference_readings" not in run.inputs:
        t0 = time.perf_counter()
        start, cams, targets, mult = _ref_start(run)
        t1 = time.perf_counter()
        run.inputs["reference_readings"] = _reference_steps(
            run, start, cams, targets, mult, unit=run.reference_unit)
        harness.log(f"reference: start and targets in {t1 - t0:.1f} s, "
                    f"{run.mix['first_steps']} steps in "
                    f"{time.perf_counter() - t1:.1f} s")
    return run.inputs["reference_readings"]


def check(run, samples):
    """Set-up's first steps against the reference's (each step's loss, each
    leaf's first gradient and change by their norms), the window's pair
    need within its budget, and the window's sampled steps' losses finite.
    When the first steps or the budget fail, every sampled step, which
    follows from them, counts as failed."""
    limits = run.mix["limits"]
    got = compare.fit_readings(run.readings, reference_readings(run))
    got["pair_need_per_budget"] = (run.readings["pair_need"]
                                   / run.readings["pair_budget"])
    got["losses_not_finite"] = sum(not math.isfinite(float(loss))
                                   for _, loss in samples)
    checks = {k: {"value": v, "limit": limits[k]} for k, v in got.items()}
    if any(not c["value"] <= c["limit"] for k, c in checks.items()
           if k != "losses_not_finite"):
        return checks, len(samples)
    return checks, got["losses_not_finite"]


def control(run, units):
    """The control's readings: the reference's first steps from its start
    stored in bfloat16, against the reference's from the start."""
    start, cams, targets, mult = _ref_start(run)
    want = _reference_steps(run, start, cams, targets, mult)
    low = _reference_steps(run, compare.bf16_splats(start), cams, targets,
                           mult)
    return compare.fit_readings(low, want)


def _unchanged(fit):
    """The step leaves the splats as they were: Adam never steps."""
    orig = fit.train_step_fn

    def train_step_fn(optimizer, *a, **kw):
        frozen = types.SimpleNamespace(zero_grad=optimizer.zero_grad,
                                       step=lambda: None)
        return orig(frozen, *a, **kw)
    return "train_step_fn", train_step_fn


def _half_batch(fit):
    """Half of the views left out, the mean taken over the rest."""
    orig = fit.l2_loss

    def l2_loss(params, valid, cameras, targets, *a, **kw):
        n = max(len(cameras) // 2, 1)
        return orig(params, valid, cameras[:n], targets[:n], *a, **kw)
    return "l2_loss", l2_loss


def _color_grad_scaled(fit):
    """One leaf's gradient altered where it is made: the colours' x 1.5."""
    orig = fit.l2_loss

    def l2_loss(params, *a, **kw):
        if not getattr(params.color, "_scaled", False):
            params.color.register_hook(lambda g: g * 1.5)
            params.color._scaled = True
        return orig(params, *a, **kw)
    return "l2_loss", l2_loss


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch,
          "color_grad_scaled": _color_grad_scaled}


@contextlib.contextmanager
def planted(name):
    """The program's trainer with the fault ``name`` planted underneath
    the timed path (CPU tests, and limits.py's fault readings)."""
    from mesh2splat_torch.train import fit

    attr, fn = FAULTS[name](fit)
    orig = getattr(fit, attr)
    setattr(fit, attr, fn)
    try:
        yield
    finally:
        setattr(fit, attr, orig)
