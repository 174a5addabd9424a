"""The texture-fitting cell at a tiny size on the CPU: its parts are found
by name, a sound run is correct and reads its metrics, and each planted
fault and the bfloat16 control come out not correct."""

import contextlib
import json

import pytest
import torch
from conftest import SEED

from m2s_bench import harness
from m2s_bench.entries import fit_textures

TEXFIT = "texfit20k_tex2048_res512.fit_textures_2view"
# readers of the device's work by the host op that launched it, or of a
# kernel's roofline: on the CPU nothing is launched
LAUNCH_READERS = {"fragment_vjp_ms.texfit", "k2_roofline.texfit"}


@pytest.fixture(autouse=True)
def few_torch_threads():
    """Two threads a test: the runs are many small ops, and the suite's
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny(spec):
    config = dict(spec.config(spec.cell(TEXFIT)["config"]), triangles=800,
                  texture_px=32, resolution=64)
    mix = dict(spec.mix(spec.cell(TEXFIT)["traffic"]), width=64, height=64)
    return config, mix


def run_tiny(spec, trace=False):
    config, mix = tiny(spec)
    return harness.run_cell(TEXFIT, SEED, 0.2, trace, device="cpu",
                            spec=spec, config=config, mix=mix)


def test_cell_parts_found_by_name(spec):
    w = spec.cell(TEXFIT)
    assert w["chips"] == 1 and len(w["why"]) <= 200
    config = spec.config(w["config"])
    assert config["name"] == w["config"]
    assert (config["texture_px"], config["resolution"]) == (2048, 512)
    assert [c for c in spec.data["configs"]
            if c["name"] == w["config"]][0]["reduced"] == []
    mix = spec.mix(w["traffic"])
    assert harness.entry_module(mix["entry"]) is fit_textures
    e2e = [m["name"] for m in spec.metrics(TEXFIT, trace=False)]
    assert e2e == ["device_ms_per_step", "setup_s"]
    layer = spec.metrics(TEXFIT, trace=True)
    assert {m["name"] for m in layer} == {
        "fragment_vjp_ms.texfit", "idle_ms.fragment_vjp.texfit",
        "k2_roofline.texfit", "device_idle_pct.texfit",
        "idle_ms.slots.texfit", "idle_ms.project.texfit", "syncs.texfit",
        "steps_per_s.texfit"}
    for m in spec.metrics(TEXFIT, False) + layer:
        assert callable(harness.metric_reader(m["name"]).read)
    for m in layer:
        assert m["moves"] == "device_ms_per_step"
        assert m["workloads"] == [TEXFIT]


@pytest.mark.parametrize("trace", [False, True])
def test_result_line(spec, trace):
    result, checks, run = run_tiny(spec, trace=trace)
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] == run.completed >= 1
    want = {m["name"] for m in spec.metrics(TEXFIT, trace)}
    got = set(result["metrics"])
    if trace:
        assert got == want - LAUNCH_READERS
        assert result["metrics"]["syncs.texfit"]["value"] == 0.0
        # the fragment VJP's span was open in the window's steps
        split = run.trace.idle_split
        assert "m2s.convert.fragment_vjp" in split
    else:
        assert got == {m["name"] for m in spec.metrics(TEXFIT, trace)
                       if m["source"] != "device_trace"}
    assert set(checks) == set(run.mix["limits"])
    assert checks["tex_grad_rel_err"]["value"] <= 1e-6
    assert checks["tex_out_of_range"]["value"] == 0
    json.dumps(result)


def _loss_not_finite(loss):
    return loss * float("nan")


@pytest.mark.parametrize("fault", [_loss_not_finite, "unchanged",
                                   "half_batch", "tex_grad_scaled",
                                   "tap_dropped"])
def test_fault_in_timed_path_is_not_correct(spec, monkeypatch, fault):
    """The rest of a run with the timed path broken underneath: each
    step's loss altered where it is produced, or (named) a fault planted
    in the program under the entry: a step that leaves the map unchanged,
    leaves half of its views out, scales the map's gradient by 1.5, or
    drops one bilinear tap's gradient in the fragment VJP."""
    if isinstance(fault, str):
        planted = fit_textures.planted(fault)
    else:
        orig = fit_textures.unit
        monkeypatch.setattr(fit_textures, "unit",
                            lambda state, i: fault(orig(state, i)))
        planted = contextlib.nullcontext()
    with planted:
        result, checks, _ = run_tiny(spec)
    assert result["correct"] is False and result["failed"] >= 1


def test_planted_faults_are_undone():
    from mesh2splat_torch.ops import fragment
    from mesh2splat_torch.train import fit

    before = (fit.texture_step_fn, fit.mean_l2,
              fragment._FragmentApply.__dict__["backward"])
    for name in fit_textures.FAULTS:
        with fit_textures.planted(name):
            pass
    assert before == (fit.texture_step_fn, fit.mean_l2,
                      fragment._FragmentApply.__dict__["backward"])


def test_control_is_not_correct(spec):
    """The control (the reference on the asset stored in bfloat16) reads
    over the cell's limit on at least one of its numbers."""
    config, mix = tiny(spec)
    run = harness.Run(spec.cell(TEXFIT), config, mix, SEED, 0.0, "cpu")
    fit_textures.make_inputs(run)
    got = fit_textures.control(run, fit_textures.limit_units(run))
    assert any(v > mix["limits"][k] for k, v in got.items()), got


def test_readings_compare_whole_maps():
    g = torch.ones(4, 4, 4)
    want = {"losses": [0.5, 0.25], "grad": g, "change": g}
    got = fit_textures.texfit_readings(
        {"losses": [0.5, 0.25], "grad": 1.5 * g, "change": 0 * g}, want)
    assert got == {"loss_rel_err": 0.0,
                   "tex_grad_rel_err": pytest.approx(0.5),
                   "tex_change_rel_err": pytest.approx(1.0)}
    short = fit_textures.texfit_readings(
        {"losses": [0.5], "grad": g, "change": g}, want)
    assert short["loss_rel_err"] == float("inf")
