#!/usr/bin/env python3
"""Where mesh2splat_torch's time goes on a CUDA card: torch.profiler over
chip_smoke.py's full-size workload (20k-triangle sphere, resolution 512;
its conversion with the textures and without them, the former also as the
port ran it before K2 read the tap atlas itself (chip_smoke.
parent_tap_gather), the latter as it ran before K2 computed local
(chip_smoke.parent_local_fill); 1080p
ALBEDO render, 1080p FINAL render with shadows, bench.py's 1024^2 shadow
cubemap, 1080p OVERDRAW render, one fit_splats step over 2 views at
1080p), after a warm-up.

    python3 profile_port.py [--rows 15]

Prints, for `Scene.convert`, each render and the training step
separately, the host wall time of the profiled call, the summed device
time, and the device ops with the most device time. Needs a card.
"""

from __future__ import annotations

import argparse
import contextlib

import chip_smoke as cs


def profile(label, fn, rows):
    r = cs.profiled(fn)
    n_cm, ms_cm = cs.cummax_ops(r)
    print(f"== {label}: wall {r['wall_ms']:.2f} ms, device busy "
          f"{r['busy_ms']:.2f} ms ({100 * r['busy_ms'] / r['wall_ms']:.1f} % "
          f"of wall), cummax {n_cm} launches {ms_cm:.3f} ms, index_select "
          f"{cs.index_selects(r)} calls")
    for title, group in (("host ops, by the device time they launched",
                          r["ops"]), ("device kernels", r["kernels"])):
        print(f"  -- {title}")
        for key, count, ms in group[:rows]:
            print(f"  {ms:9.3f} ms  {count:5d}x  {key[:90]}")


def main():
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_port: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    from mesh2splat_torch.types import RenderMode

    from mesh2splat_torch.ops import fragment as TF
    from mesh2splat_torch.ops import segments as TSEG

    scene = cs.make_scene(cs.synth_primitive(), torch.device("cuda"))
    sp = scene.convert(resolution=512, layers=6)
    for label in ("parent's path", "this tree", "this tree",
                  "parent's path"):
        with (cs.parent_tap_gather(TF) if label == "parent's path"
              else contextlib.nullcontext()):
            profile(f"Scene.convert(512, 6) ({label})",
                    lambda: scene.convert(resolution=512, layers=6),
                    args.rows)

    plain = cs.untextured_scene(cs.synth_primitive(), torch.device("cuda"))
    for label in ("parent's path", "this tree", "this tree",
                  "parent's path"):
        with (cs.parent_local_fill(TF, TSEG) if label == "parent's path"
              else contextlib.nullcontext()):
            profile(f"Scene.convert(512, 6) without textures ({label})",
                    lambda: plain.convert(resolution=512, layers=6),
                    args.rows)
    profile("Scene.render(1920x1080, ALBEDO)",
            lambda: scene.render(sp, eye=cs.EYE, width=cs.W_PX,
                                 height=cs.H_PX, fov_deg=60.0,
                                 mode=RenderMode.ALBEDO), args.rows)
    profile("Scene.render(1920x1080, FINAL, shadows=True)",
            lambda: scene.render(sp, eye=cs.EYE, width=cs.W_PX,
                                 height=cs.H_PX, fov_deg=60.0,
                                 mode=RenderMode.FINAL, shadows=True),
            args.rows)
    from mesh2splat_torch.render import binning as TB
    from mesh2splat_torch.render.shadows import (
        _shadow_prep_fused, render_shadow_cubemap,
    )

    dev = torch.device("cuda")
    mult = scene.last_config.scale_multiplier
    light = torch.tensor(cs.BENCH_LIGHT, device=dev)
    far = torch.tensor(cs.BENCH_FAR, device=dev)
    cap = TB.round_pow2_budget(int(_shadow_prep_fused(
        sp, light, far, mult, cs.SHADOW_PX)[2]))
    profile(f"shadow cubemap {cs.SHADOW_PX}^2 x 6 (bench.py's settings)",
            lambda: render_shadow_cubemap(
                sp, light, far, mult, size=cs.SHADOW_PX, method="tiled",
                pair_capacity=cap, device=dev), args.rows)
    profile("Scene.render(1920x1080, OVERDRAW)",
            lambda: scene.render(sp, eye=cs.EYE, width=cs.W_PX,
                                 height=cs.H_PX, fov_deg=60.0,
                                 mode=RenderMode.OVERDRAW), args.rows)

    from mesh2splat_torch.train import fit as TFIT

    mult = scene.last_config.scale_multiplier
    cams, targets, start = cs.training_inputs(torch, TFIT, sp, mult,
                                              torch.device("cuda"))
    params = TFIT.SplatParams.from_splats(start)
    opt = torch.optim.Adam(params.parameters(), lr=cs.FIT_LR,
                           betas=TFIT.ADAM_BETAS, eps=TFIT.ADAM_EPS)
    step = TFIT.train_step_fn(
        opt, cs.W_PX, cs.H_PX,
        pair_capacity=TFIT.pair_budget(start, cams, cs.W_PX, cs.H_PX))
    profile(f"fit_splats step (2 views at {cs.W_PX}x{cs.H_PX})",
            lambda: step(params, start.valid, cams, targets), args.rows)


if __name__ == "__main__":
    main()
