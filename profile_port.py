#!/usr/bin/env python3
"""Where mesh2splat_torch's time goes on a CUDA card: torch.profiler over
chip_smoke.py's full-size workload (20k-triangle sphere, resolution 512,
1080p ALBEDO render, 1080p FINAL render with shadows, bench.py's 1024^2
shadow cubemap, 1080p OVERDRAW render, one fit_splats step over 2 views at
1080p), after a warm-up.

    python3 profile_port.py [--rows 15]

Prints, for `Scene.convert`, each render and the training step
separately, the host wall time of the profiled call, the summed device
time, and the device ops with the most device time. Needs a card.
"""

from __future__ import annotations

import argparse
import time

import chip_smoke as cs


def profile(label, fn, rows):
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                  acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    avg = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    kernels = [e for e in avg if e.device_type == cuda]
    ops = [e for e in avg if e.device_type != cuda]
    total = sum(dev_us(e) for e in kernels) / 1e3
    print(f"== {label}: wall {wall:.2f} ms, device busy {total:.2f} ms "
          f"({100 * total / wall:.1f} % of wall)")
    for title, group in (("host ops, by the device time they launched", ops),
                         ("device kernels", kernels)):
        print(f"  -- {title}")
        for e in sorted(group, key=dev_us, reverse=True)[:rows]:
            print(f"  {dev_us(e) / 1e3:9.3f} ms  {e.count:5d}x  "
                  f"{e.key[:90]}")


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

    scene = cs.make_scene(cs.synth_primitive(), torch.device("cuda"))
    sp = scene.convert(resolution=512, layers=6)
    profile("Scene.convert(512, 6)",
            lambda: scene.convert(resolution=512, layers=6), args.rows)
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
