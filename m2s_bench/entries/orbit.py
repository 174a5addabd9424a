"""A viewer orbiting the asset: one client renders frame after frame
through ``Scene.render``, each synchronised as a frame is presented. The
eye circles the origin at ``radius``: its azimuth steps ``az_step_deg`` a
frame from a start drawn from the seed, its elevation follows
``elev_amp_deg`` on a sine of ``elev_period_frames`` frames. The splats are
the asset's conversion, made in set-up.

Mix parameters: ``width``, ``height``, ``fov_deg``, ``mode`` (a
RenderMode name), ``shadows``, the orbit's, ``warm_frames`` (poses spread
over the orbit, rendered in set-up), ``check_units`` (the frames of the
window the reference checks, a sample drawn from the seed) and ``limits``.
"""

from __future__ import annotations

import math
import random

from m2s_bench import compare, program
from m2s_bench.assets import asset_seed, synth_asset
from m2s_bench.reference import entry as ref


def eye(mix, az0_deg, i):
    az = math.radians(az0_deg + mix["az_step_deg"] * i)
    el = math.radians(mix["elev_amp_deg"]) * math.sin(
        2 * math.pi * i / mix["elev_period_frames"])
    r = mix["radius"]
    return [r * math.cos(el) * math.sin(az), r * math.sin(el),
            r * math.cos(el) * math.cos(az)]


def start_azimuth(seed):
    return random.Random(seed).uniform(0.0, 360.0)


def make_inputs(run):
    """The run's asset, made from the seed."""
    c = run.config
    run.inputs["asset"] = synth_asset(c["triangles"], c["texture_px"],
                                      asset_seed(run.seed, 0), run.device)


def limit_units(run):
    """The units the limits are read on: ``check_units`` frames of one
    orbit, drawn from the seed."""
    return sorted(random.Random(run.seed).sample(
        range(run.mix["elev_period_frames"]), run.mix["check_units"]))


def setup(run):
    from mesh2splat_torch.types import RenderMode

    c, mix = run.config, run.mix
    make_inputs(run)
    scene = program.scene(run.inputs["asset"])
    splats = scene.convert(resolution=c["resolution"], layers=c["layers"],
                           gaussian_std=c["gaussian_std"],
                           calibrated=c["calibrated"])
    state = {"scene": scene, "splats": splats, "mix": mix,
             "az0": start_azimuth(run.seed),
             "mode": RenderMode[mix["mode"]]}
    n = mix["warm_frames"]
    for j in range(n):
        unit(state, j * mix["elev_period_frames"] // n)
        run.sync()
    return state


def unit_key(state, i):
    return i


def unit(state, i):
    mix = state["mix"]
    return state["scene"].render(
        state["splats"], eye=eye(mix, state["az0"], i), width=mix["width"],
        height=mix["height"], fov_deg=mix["fov_deg"], mode=state["mode"],
        shadows=mix["shadows"])


def release(state):
    state.clear()


def _ref_splats(run):
    c = run.config
    return ref.convert(run.inputs["asset"], c["resolution"], c["layers"],
                       c["gaussian_std"], c["calibrated"])


def _ref_frame(run, splats, cfg, i):
    mix = run.mix
    return ref.render(splats, cfg, eye(mix, start_azimuth(run.seed), i),
                      mix["width"],
                      mix["height"], mix["fov_deg"], mix["mode"],
                      mix["shadows"])


def check(run, samples):
    """The reference converts the asset again and renders each sampled
    frame at its pose."""
    limits = run.mix["limits"]
    splats, cfg = _ref_splats(run)
    worst, bad = 0.0, 0
    for i, img in sorted(samples, key=lambda s: s[0]):
        with run.reference_unit(i):
            r = _ref_frame(run, splats, cfg, i)
        err = compare.image_max_err(img, r)
        worst = max(worst, err)
        bad += err > limits["image_max_err"]
        del r
    return ({"image_max_err": {"value": worst,
                               "limit": limits["image_max_err"]}}, bad)


def control(run, frames):
    """The control's reading: the given frames rendered by the reference
    from its splats stored in bfloat16, against the reference."""
    splats, cfg = _ref_splats(run)
    low = compare.bf16_splats(splats)
    worst = 0.0
    for i in frames:
        r = _ref_frame(run, splats, cfg, i)
        worst = max(worst, compare.image_max_err(
            _ref_frame(run, low, cfg, i), r))
        del r
    return {"image_max_err": worst}
