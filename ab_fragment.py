#!/usr/bin/env python3
"""K2 (kernels/csrc/fragment.cu) of this checkout against another
checkout's K2, on chip_smoke.py's full-size inputs, in one call on one CUDA
card.

    python3 ab_fragment.py [--parent DIR] [--reps 2] [--out FILE]

Builds this checkout's fragment.cu and, with --parent DIR, the fragment.cu
of the checkout in DIR, a K2 that takes the taps gathered first (timed
beside the index_select that gathers them); one nvcc process each, started
together. Unpack a commit's kernels for DIR with `git archive COMMIT
mesh2splat_torch/kernels/csrc | tar -x -C DIR`.

Inputs: the K2 calls of the textured and of the untextured conversion of
bench.py's sphere at resolution 512 (chip_smoke.synth_primitive). Each
build is checked bit-equal to the plain version on each input, then timed
by CUDA events (chip_smoke.event_ms, 20 calls) on: the textured call
reading the atlas by K1's rows, field-major and row-major (each layout
made once, outside the timing), and the untextured call in its local
mode; the builds in turns, forward then backward, reps times. Prints
each build's ptxas lines and a JSON line of times, also written to FILE
(default build/ab_fragment/ab_fragment.json). Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import time

import chip_smoke as cs

ROOT = pathlib.Path(__file__).resolve().parent
AB_DIR = ROOT / "build" / "ab_fragment"
# the wrapper's argument types before K2 took rows (records, t_pad, taps,
# meta, cap, res, geom, k, has_base, has_normal, has_mr, packed, local,
# out, stream)
_PARENT_ARGS = ("P", "L", "P", "P", "L", "I", "G", "I", "I", "I", "I", "I",
                "I", "P", "P")


def build_all(builds):
    """{name: (library path, ptxas lines)}; builds: {name: source}."""
    from mesh2splat_torch.kernels import build

    AB_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in builds.items():
        out = AB_DIR / f"lib_{name}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       out)
    libs = {}
    for name, (proc, out) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{text}")
        libs[name] = (out, [ln.strip() for ln in text.splitlines()
                            if "registers" in ln or "spill" in ln
                            or "entry function" in ln])
    return libs


def main():
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=pathlib.Path)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--out", type=pathlib.Path,
                    default=AB_DIR / "ab_fragment.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ab_fragment: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    from mesh2splat_torch import kernels
    from mesh2splat_torch.ops import fragment as TF

    src = ROOT / "mesh2splat_torch" / "kernels" / "csrc" / "fragment.cu"
    builds = {"this": src}
    if args.parent:
        builds["parent"] = (args.parent / "mesh2splat_torch" / "kernels" /
                            "csrc" / "fragment.cu")
    t0 = time.perf_counter()
    libs = build_all(builds)
    print(f"built {len(libs)} libraries in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, (_, lines) in libs.items():
        print(f"-- {name}: {builds[name]}")
        for ln in lines:
            print(f"   {ln}")

    # the inputs: the K2 calls of both conversions
    dev = torch.device("cuda")
    prim = cs.synth_primitive()
    with cs.Capture(kernels) as cap:
        cs.make_scene(prim, dev).convert(resolution=512, layers=6)
    (rec, atlas, meta), kw = cap.seen["fragment_apply"]
    rows = kw.pop("rows")
    with cs.Capture(kernels) as cap_u:
        cs.untextured_scene(prim, dev).convert(resolution=512, layers=6)
    (rec_u, taps_u, meta_u), kw_u = cap_u.seen["fragment_apply"]
    kw_u.pop("rows", None)
    atlas_fm = atlas.contiguous()           # field-major
    atlas_rm = atlas.T.contiguous().T       # row-major
    gathered = atlas.index_select(1, rows)
    ref = TF.fragment_apply_plain(rec, atlas, meta.clone(), rows=rows, **kw)
    m_ref = meta_u.clone()
    ref_u = TF.fragment_apply_plain(rec_u, taps_u, m_ref, **kw_u)
    print(f"textured: {meta.shape[1]} slots, atlas {tuple(atlas.shape)} "
          f"{atlas.dtype}, k {kw['k']}; untextured: {meta_u.shape[1]} slots",
          flush=True)

    calls = {}
    real_fn = kernels._fns.get("fragment")
    for name, (path, _) in libs.items():
        lib = ctypes.CDLL(str(path))
        fn = lib.m2s_fragment_apply
        fn.restype = ctypes.c_int
        if name == "parent":
            types = {"P": ctypes.c_void_p, "L": ctypes.c_int64,
                     "I": ctypes.c_int, "G": kernels._Geom}
            fn.argtypes = [types[c] for c in _PARENT_ARGS]

            def run(r, t, m, k, _fn=fn):
                has = k["has_base"] or k["has_normal"] or k["has_mr"]
                out = torch.empty((20, m.shape[1]), device=dev)
                err = _fn(r.data_ptr(), r.shape[1],
                          t.data_ptr() if has else None, m.data_ptr(),
                          m.shape[1], k["res"], kernels._geom(k["geom"]),
                          k["k"], int(k["has_base"]), int(k["has_normal"]),
                          int(k["has_mr"]), int(k["taps_packed"]),
                          int(k.get("local_in_kernel", False)),
                          out.data_ptr(), kernels._stream(dev))
                kernels._raise_on(err, "parent fragment_apply")
                return out

            calls[name] = {
                "textured": lambda run=run: run(rec, gathered, meta, kw),
                "local": lambda run=run: run(rec_u, taps_u, meta_u, dict(
                    kw_u, local_in_kernel=True))}
        else:
            fn.argtypes = kernels._SIGNATURES["fragment"][1]

            def run(r, t, m, k, rw=None, _fn=fn):
                kernels._fns["fragment"] = _fn
                try:
                    return kernels.fragment_apply(r, t, m, rows=rw, **k)
                finally:
                    kernels._fns["fragment"] = real_fn

            calls[name] = {
                "textured": lambda run=run: run(rec, atlas_fm, meta, kw,
                                                rows),
                "textured_row": lambda run=run: run(rec, atlas_rm, meta, kw,
                                                    rows),
                "local": lambda run=run: run(rec_u, taps_u, meta_u, dict(
                    kw_u, local_in_kernel=True))}
    for name, modes in calls.items():
        for mode, fn in modes.items():
            out = fn()
            want = ref_u if mode == "local" else ref
            ok = cs.bits_equal(out, want) and (
                mode != "local" or torch.equal(meta_u, m_ref))
            print(f"{name} {mode}: bit-equal to the plain version {ok}",
                  flush=True)
            cs.check(ok, f"{name} {mode} differs from the plain version")

    times = {name: {mode: [] for mode in modes}
             for name, modes in calls.items()}
    times["gather"] = {"index_select": []}
    order = list(calls)
    for rep in range(args.reps):
        for name in (order if rep % 2 == 0 else order[::-1]):
            for mode, fn in calls[name].items():
                times[name][mode].append(cs.event_ms(fn, 20))
        times["gather"]["index_select"].append(
            cs.event_ms(lambda: atlas.index_select(1, rows), 20))
    for name, modes in times.items():
        print(f"{name}: " + ", ".join(
            f"{mode} " + " / ".join(f"{t:.4f}" for t in ts)
            for mode, ts in modes.items()) + f" ms ({smi})", flush=True)
    result = {"card": smi, "slots": meta.shape[1],
              "slots_untextured": meta_u.shape[1],
              "sources": {n: str(b) for n, b in builds.items()},
              "ptxas": {n: lines for n, (_, lines) in libs.items()},
              "ms": times}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps({"ms": times}))


if __name__ == "__main__":
    main()
