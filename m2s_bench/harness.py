"""The benchmark's core: finds a cell's parts by name, runs its set-up, its
measured window and the reference's check, and builds the result line.

Everything a cell is made of sits in a file of its own, found by the name
that ``BENCHMARK.json`` gives it:

  configs/<file>.json       the deployment (named by the config's ``file``)
  mixes/<traffic>.json      the traffic mix: parameters of one entry
  entries/<entry>.py        the code that drives one user entry of the port,
                            and its check against the reference
  metrics/<metric>.py       one metric's reader: ``read(run)``
  roofline/<kernel>.py      one kernel's work counts on the reference's
                            inputs

so a later cell, mix or metric is added as files, with no edit here.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import math
import pathlib
import random
import sys
import time

import torch

from . import peaks
from .trace import Trace

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mesh2splat_tpu")


def load_file(path: pathlib.Path):
    """A module from a file whose name may hold dots (metric names)."""
    name = "m2s_bench._loaded." + path.stem.replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Spec:
    """BENCHMARK.json and the files it names."""

    def __init__(self, path: pathlib.Path = ROOT / "BENCHMARK.json"):
        self.data = json.loads(path.read_text())

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return json.loads((ROOT / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    @staticmethod
    def mix(traffic: str) -> dict:
        return json.loads((HERE / "mixes" / f"{traffic}.json").read_text())

    def metrics(self, cell: str, trace: bool) -> list:
        """The metrics the cell reports: its end-to-end ones, or with a
        trace its per-layer ones (those listing it, or listing no cell)."""
        group = self.data["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if "workloads" not in m or cell in m["workloads"]]


def entry_module(name: str):
    return importlib.import_module(f"m2s_bench.entries.{name}")


def metric_reader(name: str):
    return load_file(HERE / "metrics" / f"{name}.py")


def roofline_modules() -> list:
    return [load_file(p) for p in sorted((HERE / "roofline").glob("*.py"))]


class Sampler:
    """A uniform sample of at most k of the window's outputs (reservoir
    sampling, drawn from the seed): a replaced output is freed."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.items: list = []   # (unit index, output)
        self.seen = 0

    def offer(self, i: int, out) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append((i, out))
            return
        j = self.rng.randrange(self.seen)
        if j < self.k:
            self.items[j] = (i, out)


class Run:
    """One run of one cell: what set-up, the window and the check leave for
    the metric readers."""

    def __init__(self, cell: dict, config: dict, mix: dict, seed: int,
                 seconds: float, device: str):
        self.cell, self.config, self.mix = cell, config, mix
        self.seed, self.seconds = seed, seconds
        self.device = torch.device(device)
        self.inputs: dict = {}         # what the benchmark made
        self.setup_s = self.window_s = 0.0
        self.latencies_s: list = []
        self.unit_keys: list = []      # the reference's key of each unit
        self.bounds: dict = {}         # kernel -> {key: bound s}
        self.readings: dict = {}       # what set-up read of the program
        self.trace: Trace | None = None
        self.memory_peak_bytes = 0
        self._ref_key = None

    @property
    def completed(self) -> int:
        return len(self.latencies_s)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def reference_unit(self, key):
        """Work counted by the roofline modules inside this block belongs
        to the window's units with this key."""
        self._ref_key = key
        try:
            yield
        finally:
            self._ref_key = None

    def add_bound(self, kernel: str, seconds: float) -> None:
        per_key = self.bounds.setdefault(kernel, {})
        per_key[self._ref_key] = per_key.get(self._ref_key, 0.0) + seconds


@contextlib.contextmanager
def counting_kernels(run: Run, kernels: set):
    """While the reference runs, the target (a plain version in the
    reference) of each roofline module of ``kernels`` is wrapped so that
    each call adds its bound to the run."""
    undo = []
    try:
        for mod in roofline_modules():
            if mod.KERNEL not in kernels:
                continue
            ref = importlib.import_module(f"m2s_bench.reference.{mod.TARGET[0]}")
            orig = getattr(ref, mod.TARGET[1])

            def wrapper(*args, _mod=mod, _orig=orig, **kw):
                out, (nbytes, flops) = _mod.counted(_orig, *args, **kw)
                run.add_bound(_mod.KERNEL, peaks.bound_s(nbytes, flops))
                return out

            setattr(ref, mod.TARGET[1], wrapper)
            undo.append((ref, mod.TARGET[1], orig))
        yield
    finally:
        for ref, name, orig in reversed(undo):
            setattr(ref, name, orig)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def _window(run: Run, entry, state, sampler: Sampler) -> None:
    """Closed loop: unit after unit, each synchronised, until the first
    one that ends past ``seconds``; every unit counts."""
    run.sync()
    t0 = time.perf_counter()
    t_end = t0 + run.seconds
    i = 0
    while True:
        ts = time.perf_counter()
        out = entry.unit(state, i)
        run.sync()
        te = time.perf_counter()
        run.latencies_s.append(te - ts)
        run.unit_keys.append(entry.unit_key(state, i))
        sampler.offer(i, out)
        del out
        i += 1
        if te >= t_end:
            break
    run.window_s = te - t0


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None,
             spec: Spec | None = None, config: dict | None = None,
             mix: dict | None = None):
    """Run one cell once. Returns (result dict, checks, Run). ``config``
    and ``mix`` replace the cell's files (the tests' small sizes)."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec = spec or Spec()
    cell = spec.cell(workload)
    config = config or spec.config(cell["config"])
    mix = mix or spec.mix(cell["traffic"])
    run = Run(cell, config, mix, seed, seconds, device)
    entry = entry_module(mix["entry"])

    state = entry.setup(run)
    run.sync()
    run.setup_s = time.perf_counter() - t_start
    if run.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(run.device)
    sampler = Sampler(mix["check_units"], seed)
    # set-up's garbage collected and its objects frozen, so that the
    # window's collections do not scan them
    gc.collect()
    gc.freeze()
    # a cell with an end-to-end metric read from the device's trace has
    # the card traced in its untraced runs too (the card only, no host ops)
    card_only = not trace and run.device.type == "cuda" and any(
        m["source"] == "device_trace" for m in spec.metrics(workload, False))
    if trace or card_only:
        from torch.profiler import ProfilerActivity, profile

        acts = [] if card_only else [ProfilerActivity.CPU]
        if run.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            _window(run, entry, state, sampler)
            t_stop = time.perf_counter()
        t_parse = time.perf_counter()
        run.trace = Trace(prof, run.window_s, detail=trace)
        del prof
        log(f"profiler stopped in {t_parse - t_stop:.1f} s, trace read in "
            f"{time.perf_counter() - t_parse:.1f} s")
    else:
        _window(run, entry, state, sampler)
    gc.unfreeze()
    log(f"set-up {run.setup_s:.1f} s, window {run.window_s:.1f} s, "
        f"{run.completed} units")
    if run.device.type == "cuda":
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(
            run.device))
    entry.release(state)
    del state
    if run.device.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    # the kernels whose share of the roofline (<kernel>_roofline.*) the
    # cell reports
    shares = {m["name"].split("_roofline")[0]
              for m in spec.metrics(workload, True)
              if "_roofline" in m["name"]}
    with (counting_kernels(run, shares) if trace
          else contextlib.nullcontext()):
        checks, n_bad = entry.check(run, sampler.items)
    log(f"reference check in {time.perf_counter() - t_ref:.1f} s")
    del sampler
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())

    t_read = time.perf_counter()
    metrics = {}
    for m in spec.metrics(workload, trace):
        value = metric_reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    log(f"metrics read in {time.perf_counter() - t_read:.1f} s")
    result = {"correct": correct, "attempted": run.completed,
              "failed": n_bad, "metrics": metrics,
              "device": device_info(run, trace)}
    if trace and run.trace is not None:
        result["breakdown"] = {"device_ops": run.trace.top_device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    return result, checks, run


def device_info(run: Run, trace: bool) -> dict:
    if run.device.type == "cuda":
        info = {"platform": "gpu",
                "kind": torch.cuda.get_device_name(run.device),
                "count": int(run.cell["chips"]),
                "memory_peak_bytes": run.memory_peak_bytes}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    if trace and run.trace is not None:
        info["busy_s"] = run.trace.busy_s
        info["window_s"] = run.trace.window_s
    return info
