"""A run's result line, its isolation from JAX, and its check: sound runs
come out correct, runs with a fault planted in the timed path and the
bfloat16 control come out not correct."""

import contextlib
import json
import pathlib
import subprocess
import sys

import pytest
import torch
from conftest import ALBEDO, CONVERT, FIT, SEED, SHADOWS, run_tiny, \
    tiny_config, tiny_mix

from m2s_bench import harness
from m2s_bench.entries import convert_queue, fit_splats, orbit

ROOT = pathlib.Path(__file__).resolve().parents[2]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


# readers of the device's work by the host op that launched it: on the CPU
# nothing is launched
LAUNCH_READERS = {"gather_bwd_ms.fit"}


@pytest.mark.parametrize("cell", [CONVERT, SHADOWS, FIT])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(spec, cell, trace):
    result, checks, run = run_tiny(spec, cell, trace=trace)
    assert list(result) == KEYS + (["breakdown"] if trace else [])
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] == run.completed >= 1
    want = {m["name"] for m in spec.metrics(cell, trace)}
    got = set(result["metrics"])
    if trace:   # on the CPU no kernel ran: the roofline readers find nothing
        assert got == {n for n in want
                       if "roofline" not in n and n not in LAUNCH_READERS}
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(result["device"])
    else:   # on the CPU no card is traced: its trace's metrics are absent
        assert got == {m["name"] for m in spec.metrics(cell, trace)
                       if m["source"] != "device_trace"}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert all(set(c) == {"value", "limit"} for c in checks.values())
    json.dumps(result)


def test_run_py_needs_a_card():
    """Without a CUDA card run.py exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    p = subprocess.run([sys.executable, "m2s_bench/run.py", "--workload",
                        CONVERT, "--seed", "1", "--seconds", "1", "--trace",
                        "0"], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def _modules_after(code):
    p = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, {str(ROOT)!r})"
         f"\n{code}\nprint(' '.join(sorted(sys.modules)))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    return {m.split(".")[0] for m in p.stdout.split()}


def test_no_jax_anywhere():
    """Nothing the benchmark imports, nor what a run loads, has the
    top-level name jax, jaxlib, flax or mesh2splat_tpu (compared whole:
    mesh2splat_torch begins with the JAX package's name)."""
    tops = _modules_after(
        "import glob, m2s_bench.run, m2s_bench.harness, m2s_bench.limits\n"
        "from m2s_bench import harness\n"
        "import m2s_bench.entries.convert_queue, m2s_bench.entries.orbit\n"
        "import m2s_bench.entries.fit_splats\n"
        "[harness.load_file(__import__('pathlib').Path(p)) for p in "
        "glob.glob('m2s_bench/metrics/*.py') + "
        "glob.glob('m2s_bench/roofline/*.py')]\n"
        "import mesh2splat_torch.scene, mesh2splat_torch.train.fit")
    assert "mesh2splat_torch" in tops
    assert not tops & set(harness.FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    tops = _modules_after(
        "import m2s_bench.reference.entry, m2s_bench.counting\n"
        "import m2s_bench.reference.render.pipeline\n"
        "import m2s_bench.reference.train")
    assert not tops & {"mesh2splat_torch", *harness.FORBIDDEN}


def _alter_one_value(splats):
    i = int(torch.nonzero(splats.valid)[0, 0])
    splats.color[i, 0] += 0.01
    return splats


def _drop_half(splats):
    splats.valid[::2] = False
    return splats


def _alter_one_pixel(img):
    img[0, 0, 0] += 0.1
    return img


def _drop_half_rows(img):
    img[: img.shape[0] // 2] = 0.0
    return img


def _loss_not_finite(loss):
    return loss * float("nan")


@pytest.mark.parametrize("cell,module,fault", [
    (CONVERT, convert_queue, _alter_one_value),
    (CONVERT, convert_queue, _drop_half),
    (SHADOWS, orbit, _alter_one_pixel),
    (SHADOWS, orbit, _drop_half_rows),
    (ALBEDO, orbit, _alter_one_pixel),
    (FIT, fit_splats, _loss_not_finite),
    (FIT, fit_splats, "unchanged"),
    (FIT, fit_splats, "half_batch"),
    (FIT, fit_splats, "color_grad_scaled"),
])
def test_fault_in_timed_path_is_not_correct(spec, monkeypatch, cell, module,
                                            fault):
    """The rest of a run with the timed path broken underneath: every
    output altered where it is produced, or (named) a fault planted in the
    program under the entry: a trainer's step that leaves its state
    unchanged, leaves half of its views out, or alters one gradient."""
    if isinstance(fault, str):
        planted = module.planted(fault)
    else:
        orig = module.unit
        monkeypatch.setattr(module, "unit",
                            lambda state, i: fault(orig(state, i)))
        planted = contextlib.nullcontext()
    with planted:
        result, checks, _ = run_tiny(spec, cell)
    assert result["correct"] is False and result["failed"] >= 1


@pytest.mark.parametrize("cell,module", [
    (CONVERT, convert_queue), (SHADOWS, orbit), (ALBEDO, orbit),
    (FIT, fit_splats)])
def test_control_is_not_correct(spec, cell, module):
    """The control (the reference's splats stored in bfloat16) reads over
    the cell's limit on at least one of its numbers."""
    w = spec.cell(cell)
    config, mix = tiny_config(spec, cell), tiny_mix(spec, cell)
    run = harness.Run(w, config, mix, SEED, 0.0, "cpu")
    module.make_inputs(run)
    got = module.control(run, module.limit_units(run))
    assert any(v > mix["limits"][k] for k, v in got.items()), got


@pytest.mark.parametrize("metric", ["device_ms_per_conversion",
                                    "device_ms_per_step"])
def test_device_ms_per_conversion_reads_the_card_trace(metric):
    """The card's busy time over the units completed; nothing without a
    trace or with an idle card."""
    read = harness.metric_reader(metric).read

    class Run:
        trace, latencies_s = None, [0.1] * 4
        completed = 4

    assert read(Run) is None
    Run.trace = type("T", (), {"busy_s": 0.0})
    assert read(Run) is None
    Run.trace.busy_s = 0.3
    assert read(Run) == pytest.approx(75.0)
