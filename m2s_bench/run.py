#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once, on the CUDA card of this machine:

    python3 m2s_bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up makes the cell's inputs from the seed and warms up every shape the
window uses; the window then drives the port's user entry for ``--seconds``;
the reference checks a sample of what the window produced. The last line of
standard output is the result's JSON object: with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics from a
torch.profiler trace of the window. The numbers compared, each beside its
limit, close standard error and the result line. Exits non-zero, with no
result, without enough CUDA cards, or if jax, jaxlib, flax or the JAX
package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
os.environ.setdefault("USE_FLAX", "0")
# one process drives the card; its host work is Python and launches, so
# few CPU threads keep the host's pace steadier
os.environ.setdefault("OMP_NUM_THREADS", "1")


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from m2s_bench import harness

    torch.set_num_threads(1)

    spec = harness.Spec()
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2

    result, checks, _ = harness.run_cell(
        args.workload, args.seed, args.seconds, bool(args.trace),
        device="cuda", t_start=T_START, spec=spec)
    found = harness.forbidden_modules()
    if found:
        print(f"the run loaded {found}: the port and the benchmark must not "
              "load jax, jaxlib, flax or the JAX package", file=sys.stderr)
        return 3
    result["card"] = power_limit()
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
