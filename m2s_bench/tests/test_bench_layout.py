"""The harness finds every part of a cell by its name, from its file, and
BENCHMARK.json keeps to the benchmark's contract's shape."""

import json
import re

import pytest
from conftest import ALBEDO, CONVERT, FIT, SHADOWS

from m2s_bench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys(spec):
    assert list(spec.data) == ["command", "paths", "run_seconds", "configs",
                               "workloads", "end_to_end", "per_layer"]
    assert spec.data["command"] == ["python3", "m2s_bench/run.py"]
    assert spec.data["paths"] == ["m2s_bench"]
    assert 1 <= spec.data["run_seconds"] <= 51


@pytest.mark.parametrize("cell", [CONVERT, SHADOWS, ALBEDO, FIT])
def test_cell_parts_found_by_name(spec, cell):
    w = spec.cell(cell)
    assert w["chips"] == 1 and len(w["why"]) <= 200
    config = spec.config(w["config"])
    assert config["name"] == w["config"]
    mix = spec.mix(w["traffic"])
    entry = harness.entry_module(mix["entry"])
    for fn in ("make_inputs", "setup", "unit", "unit_key", "release",
               "check", "control", "limit_units"):
        assert callable(getattr(entry, fn))
    e2e = [m["name"] for m in spec.metrics(cell, trace=False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = spec.metrics(cell, trace=True)
    assert layer
    for m in spec.metrics(cell, False) + layer:
        assert callable(harness.metric_reader(m["name"]).read)
    for m in layer:
        assert m["moves"] in e2e


def test_metric_and_config_entries(spec):
    names = set()
    for group in ("end_to_end", "per_layer"):
        for m in spec.data[group]:
            assert NAME.match(m["name"]) and m["name"] not in names
            names.add(m["name"])
            assert m["better"] in ("lower", "higher")
            if "roofline" in m["name"]:
                assert m["unit"] == "%"
    for m in spec.data["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for c in spec.data["configs"]:
        assert c["file"].startswith("m2s_bench/configs/")
        assert json.loads((harness.ROOT / c["file"]).read_text())[
            "name"] == c["name"]


def test_roofline_modules_found():
    mods = {m.KERNEL: m for m in harness.roofline_modules()}
    assert set(mods) >= {"k2", "k3", "k4", "k5"}
    for m in mods.values():
        assert callable(m.counted) and m.PATTERN and len(m.TARGET) == 2


def test_every_reader_has_a_metric(spec):
    """Each reader under metrics/ reads a metric that BENCHMARK.json names:
    a retired metric takes its reader with it."""
    names = {m["name"] for g in ("end_to_end", "per_layer")
             for m in spec.data[g]}
    files = {p.stem for p in (harness.HERE / "metrics").glob("*.py")}
    assert files == names
