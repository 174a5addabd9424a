#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card at the
cell's own size, in one process:

    python3 m2s_bench/limits.py --workload <name> --seeds 12 \
        --control-seeds 3 --first-seed <n>

For each of ``--seeds`` seeds the program's set-up runs, then the units
the check would sample (every asset of a queue; ``check_units`` frames of
one orbit drawn from the seed), then the reference's check: the numbers
compared, as a sound run reads them. For each of ``--control-seeds``
seeds the control (the reference with its splats stored in bfloat16) is
read against the reference on the same units. One JSON line a seed, then
the largest program reading and the smallest control reading of each
number. The benchmark's own runs never run the control.

``--faults a,b --fault-seeds 3`` also reads, on the first seeds, the
program with each of the entry's planted faults (``entry.planted``; a
trainer's), against the same seed's reference readings.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
KEEP = ("reference_readings",)   # what runs of one seed share


def program_reading(harness, spec, workload, seed, device, fault=None,
                    inputs=None):
    cell = spec.cell(workload)
    config, mix = spec.config(cell["config"]), spec.mix(cell["traffic"])
    run = harness.Run(cell, config, mix, seed, 0.0, device)
    run.inputs.update(inputs or {})
    entry = harness.entry_module(mix["entry"])
    with entry.planted(fault) if fault else contextlib.nullcontext():
        state = entry.setup(run)
        units = entry.limit_units(run)
        run.unit_keys = [entry.unit_key(state, i)
                         for i in range(max(units) + 1)]
        samples = []
        for i in units:
            samples.append((i, entry.unit(state, i)))
            run.sync()
        entry.release(state)
    checks, bad = entry.check(run, samples)
    kept = {k: run.inputs[k] for k in KEEP if k in run.inputs}
    return {k: c["value"] for k, c in checks.items()}, bad, kept


def control_reading(harness, spec, workload, seed, device):
    cell = spec.cell(workload)
    config, mix = spec.config(cell["config"]), spec.mix(cell["traffic"])
    run = harness.Run(cell, config, mix, seed, 0.0, device)
    entry = harness.entry_module(mix["entry"])
    entry.make_inputs(run)
    return entry.control(run, entry.limit_units(run))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2_000_000_011)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=int, default=3)
    args = ap.parse_args(argv)
    faults = [f for f in args.faults.split(",") if f]

    import torch

    from m2s_bench import harness

    spec = harness.Spec()
    prog_max: dict = {}
    ctrl_min: dict = {}
    fault_min: dict = {}
    for j in range(args.seeds):
        seed = args.first_seed + 7919 * j
        t0 = time.perf_counter()
        got, bad, kept = program_reading(harness, spec, args.workload, seed,
                                         args.device)
        for k, v in got.items():
            prog_max[k] = max(prog_max.get(k, v), v)
        print(json.dumps({"side": "program", "seed": seed, "readings": got,
                          "units_over_limit": bad,
                          "seconds": time.perf_counter() - t0}), flush=True)
        for f in faults if j < args.fault_seeds else ():
            t0 = time.perf_counter()
            got, bad, _ = program_reading(harness, spec, args.workload, seed,
                                          args.device, fault=f, inputs=kept)
            mins = fault_min.setdefault(f, {})
            for k, v in got.items():
                mins[k] = min(mins.get(k, v), v)
            print(json.dumps({"side": f"fault:{f}", "seed": seed,
                              "readings": got, "units_over_limit": bad,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
        if args.device == "cuda":
            torch.cuda.empty_cache()
    for j in range(args.control_seeds):
        seed = args.first_seed + 104729 * (j + 1)
        t0 = time.perf_counter()
        got = control_reading(harness, spec, args.workload, seed, args.device)
        for k, v in got.items():
            ctrl_min[k] = min(ctrl_min.get(k, v), v)
        print(json.dumps({"side": "control", "seed": seed, "readings": got,
                          "seconds": time.perf_counter() - t0}), flush=True)
        if args.device == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload,
                      "program_max": prog_max, "control_min": ctrl_min,
                      "fault_min": fault_min,
                      "limits": spec.mix(spec.cell(args.workload)["traffic"])
                      ["limits"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
