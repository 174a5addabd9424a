"""Small sizes for the benchmark's CPU tests: the cells' own parts, with a
tiny asset and a small frame, on the CPU (the port's plain versions)."""

import pathlib
import sys

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

from m2s_bench import harness  # noqa: E402

CONVERT = "asset100k_tex2048_res1024.convert_queue"
SHADOWS = "asset20k_tex512_res512.orbit_final_shadows"
ALBEDO = "asset100k_tex2048_res1024.orbit_albedo"
FIT = "asset20k_tex512_res512.fit_splats_2view"
SEED = 3_000_000_019


@pytest.fixture(scope="module")
def spec():
    return harness.Spec()


def tiny_config(spec, cell):
    base = spec.config(spec.cell(cell)["config"])
    return dict(base, triangles=800, texture_px=32, resolution=64,
                queue_assets=2)


def tiny_mix(spec, cell):
    mix = spec.mix(spec.cell(cell)["traffic"])
    if mix["entry"] == "orbit":
        mix.update(width=128, height=96, warm_frames=1)
    if mix["entry"] == "fit_splats":
        mix.update(width=64, height=64)
    return mix


def run_tiny(spec, cell, trace=False, seconds=0.2, seed=SEED):
    return harness.run_cell(cell, seed, seconds, trace, device="cpu",
                            spec=spec, config=tiny_config(spec, cell),
                            mix=tiny_mix(spec, cell))
