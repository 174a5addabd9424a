"""A batch conversion queue: one client converts the run's assets in turn
through ``Scene.convert`` (calibration included), each conversion
synchronised as a pipeline would before writing its result.

Mix parameters: ``fixed_shapes``, every run converts the same set of
shapes (the seed draws their maps and the queue's order), so that every
seed asks the same work of the card; ``check_units``, the conversions of
the window that the reference checks (a sample drawn from the seed);
``limits``, the limit of each number compared."""

from __future__ import annotations

import random

from m2s_bench import compare, program
from m2s_bench.assets import make_assets
from m2s_bench.reference import entry as ref


def _kw(config):
    return dict(resolution=config["resolution"], layers=config["layers"],
                gaussian_std=config["gaussian_std"],
                calibrated=config["calibrated"])


def make_inputs(run):
    """The run's assets, made from the seed."""
    run.inputs["assets"] = make_assets(
        run.config, run.seed, run.device,
        fixed_shapes=run.mix.get("fixed_shapes", False))


def limit_units(run):
    """The units the limits are read on: one conversion of each asset."""
    return list(range(len(run.inputs["assets"])))


def setup(run):
    make_inputs(run)
    scenes = [program.scene(a) for a in run.inputs["assets"]]
    state = {"scenes": scenes, "kw": _kw(run.config),
             "start": random.Random(run.seed).randrange(len(scenes))}
    for sc in scenes:     # the warm-up: one pass over the queue
        sc.convert(**state["kw"])
        run.sync()
    return state


def unit_key(state, i):
    return (state["start"] + i) % len(state["scenes"])


def unit(state, i):
    return state["scenes"][unit_key(state, i)].convert(**state["kw"])


def release(state):
    state.clear()


def _reference(run, key):
    c = run.config
    with run.reference_unit(key):
        splats, _ = ref.convert(run.inputs["assets"][key], c["resolution"],
                                c["layers"], c["gaussian_std"],
                                c["calibrated"])
    return splats


def check(run, samples):
    """Every asset of the queue converted by the reference (so that the
    traced run counts K2's work for every conversion of its window), each
    sampled conversion compared with its asset's."""
    limits = run.mix["limits"]
    worst = {"splat_count_diff": 0, "splat_max_err": 0.0}
    bad = 0
    for key in range(len(run.inputs["assets"])):
        r = _reference(run, key)
        for i, out in samples:
            if run.unit_keys[i] != key:
                continue
            got = compare.splat_readings(out, r)
            worst["splat_count_diff"] = max(worst["splat_count_diff"],
                                            got["count_diff"])
            worst["splat_max_err"] = max(worst["splat_max_err"],
                                         got["max_err"])
            bad += (got["count_diff"] > limits["splat_count_diff"]
                    or got["max_err"] > limits["splat_max_err"])
        del r
    return ({k: {"value": v, "limit": limits[k]} for k, v in worst.items()},
            bad)


def control(run, units):
    """The control's readings: each asset's reference splats stored in
    bfloat16, against the reference (``units`` is not needed: every asset
    is read)."""
    worst = {"splat_count_diff": 0, "splat_max_err": 0.0}
    for key in range(len(run.inputs["assets"])):
        r = _reference(run, key)
        got = compare.splat_readings(compare.bf16_splats(r), r)
        worst["splat_count_diff"] = max(worst["splat_count_diff"],
                                        got["count_diff"])
        worst["splat_max_err"] = max(worst["splat_max_err"], got["max_err"])
    return worst
