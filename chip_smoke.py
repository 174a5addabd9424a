#!/usr/bin/env python3
"""Smoke run of mesh2splat_torch on one CUDA card (written for an H100).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero, and the run prints no result
without a card:
  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: every CUDA kernel from the sources in this checkout (one nvcc
     per source, all at once), with -Xptxas -v's register/spill lines;
  3. the main path at full size, through the user's entry points: a
     20k-triangle textured sphere (bench.py's workload, built in numpy from
     seed 0) as a Scene on cuda -> convert(512, 6) -> export_ply in all three
     formats -> 1920x1080 renders in ALBEDO and FINAL -> an albedo-only tiled
     raster; then the training paths at full size: fit_splats (3 Adam steps,
     2 views at 1920x1080, the 1,534,657 splats), fit_textures (the sphere at
     resolution 512, two 512x512 views, 2 steps), bench.py's 1080p gradient
     and the five-target G-buffer loss's gradient (the full composite
     backward); then the render paths at full size: bench.py's 1024^2
     shadow cubemap, the 1920x1080 FINAL frame with shadows, the OVERDRAW
     frame, the frame with the mesh depth prepass and the split-screen
     compare; the kernels' launch counters are zeroed before each path and
     read after it, and no render may drop a class-C pair;
  4. each kernel against its plain PyTorch version on the same CUDA tensors,
     at the shapes of phase 3 (K3 also the pairs each tile walked; K4's
     state pass its per-segment states), with the tile histograms of the
     composite's inputs;
  5. the whole slice on the card against the same code on the CPU, small:
     conversion and render, one fit_splats loss and gradient, one
     fit_textures gradient, the tiled cubemap at 128^2, the FINAL frame
     with shadows, the OVERDRAW, depth-tested and split-screen frames;
  6. kernel times (CUDA events) beside the plain versions and the bound
     (and the naive walk's figure, the bound the first kernels were held
     to), K3's and K4's time on their fullest tile alone, each kernel's
     registers, spills, shared memory and resident warps, the training
     step's time and the render paths' times.
It ends with a JSON line of kernel numbers, the card's name and power limit,
and {"ok": true, "device": {...}} as the last line.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
W_PX, H_PX = 1920, 1080
EYE = [0.0, 0.0, 3.2]         # bench.py's 1080p camera
EYE2 = [0.8, 0.4, 3.0]        # the second training view
FIT_STEPS = 3
FIT_LR = 1e-2
TEX_STEPS = 2
TEX_PX = 512                  # fit_textures' views
MAIN_KERNELS = ("texel_rows", "fragment_apply", "composite_full",
                "composite_albedo")
BENCH_LIGHT, BENCH_FAR, SHADOW_PX = [0.5, 1.5, 2.0], 10.0, 1024  # bench.py
RENDER_CALLS = 5


def log(msg):
    print(msg, flush=True)


def synth_primitive(n_tri=20_000, tex=512, seed=0):
    """bench.py's synth_mesh (a perturbed lat-long sphere with 512^2
    base-colour, normal and metallic-roughness maps) in numpy, as the
    GltfPrimitive a GLB load would give."""
    from mesh2splat_torch.io.gltf import GltfPrimitive

    rng = np.random.default_rng(seed)
    rows = int(np.sqrt(n_tri / 2))
    cols = (n_tri // 2) // max(rows, 1)
    th = np.linspace(0.15, np.pi - 0.15, rows + 1)
    ph = np.linspace(0, 2 * np.pi, cols + 1)
    T, Pg = np.meshgrid(th, ph, indexing="ij")
    r = 1.0 + 0.05 * rng.standard_normal(T.shape)
    verts = np.stack([r * np.sin(T) * np.cos(Pg), r * np.cos(T),
                      r * np.sin(T) * np.sin(Pg)], -1).astype(np.float32)
    quads = []
    for i in range(rows):
        for j in range(cols):
            a, b = verts[i, j], verts[i + 1, j]
            c, d = verts[i + 1, j + 1], verts[i, j + 1]
            quads.append((a, b, c))
            quads.append((a, c, d))
    tri_pos = np.asarray(quads, np.float32)[:n_tri]
    fn = np.cross(tri_pos[:, 1] - tri_pos[:, 0], tri_pos[:, 2] - tri_pos[:, 0])
    fn /= np.linalg.norm(fn, axis=-1, keepdims=True) + 1e-12
    return GltfPrimitive(
        name="synth",
        tri_pos=tri_pos,
        tri_normal=np.repeat(fn[:, None], 3, axis=1).astype(np.float32),
        tri_tangent=np.broadcast_to(
            [1, 0, 0, 1.0], tri_pos.shape[:2] + (4,)).astype(np.float32),
        tri_uv=(tri_pos[..., :2] * 0.25 + 0.5).astype(np.float32),
        base_color_factor=np.ones(4, np.float32),
        metallic_factor=1.0,
        roughness_factor=1.0,
        base_color_tex=rng.uniform(0, 1, (tex, tex, 4)).astype(np.float32),
        normal_tex=np.clip(rng.normal(0.5, 0.1, (tex, tex, 3)), 0, 1)
        .astype(np.float32),
        metallic_roughness_tex=rng.uniform(0, 1, (tex, tex, 3))
        .astype(np.float32),
    )


def make_scene(prim, device):
    from mesh2splat_torch.io import gltf
    from mesh2splat_torch.scene import Scene

    return Scene(primitives=[(*gltf.to_device(prim, device), prim)])


class Capture:
    """Records the arguments of the kernel wrappers while the main path
    runs (the wrappers still launch; nothing else changes)."""

    def __init__(self, kernels):
        self.kernels = kernels
        self.seen = {}
        self.saved = {}

    def __enter__(self):
        for name in ("texel_rows", "fragment_apply", "composite_forward",
                     "composite_backward", "min_depth", "overdraw"):
            real = getattr(self.kernels, name)
            self.saved[name] = real

            def spy(*args, _real=real, _name=name, **kw):
                key = _name
                if _name.startswith("composite"):
                    key += "_albedo" if kw["albedo_only"] else "_full"
                self.seen.setdefault(key, (args, kw))
                return _real(*args, **kw)

            setattr(self.kernels, name, spy)
        return self

    def __exit__(self, *exc):
        for name, real in self.saved.items():
            setattr(self.kernels, name, real)


class Record:
    """Records what a module-level function returns while a path runs (the
    function still runs; nothing else changes): each binning's
    dropped_pairs (every render bins once, a cubemap once), the shadow
    factor of a frame."""

    def __init__(self, module, name, pick=lambda out: out):
        self.module, self.name, self.pick = module, name, pick
        self.real = getattr(module, name)
        self.got = []

    def _call(self, *args, **kw):
        out = self.real(*args, **kw)
        self.got.append(self.pick(out))
        return out

    def __enter__(self):
        setattr(self.module, self.name, self._call)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)

    def take(self):
        got, self.got = self.got, []
        return got


def sync():
    import torch

    torch.cuda.synchronize()


def host_ms(fn, n, warm=1):
    for _ in range(warm):
        fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    sync()
    return (time.perf_counter() - t0) / n * 1e3


def event_ms(fn, n, warm=2):
    import torch

    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / n


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def covered_pairs(torch, fields, starts, kw, variant, chunks=None,
                  tile_batch=256):
    """The (pair, pixel) combinations the plain coverage test (g > 0) finds
    covered on these inputs, for the operations bounds: over every chunk of
    every tile, or over chunks [lo, hi) of each tile where ``chunks`` gives
    the per-tile (lo, hi) (K3's walked chunks, K4's state pass). Returns
    (covered, pairs in those chunks)."""
    from mesh2splat_torch.render import binning as TB
    from mesh2splat_torch.render import composite as TCOMP

    idx = TB.field_index(variant)
    first, ends, aligned, num_chunks = TCOMP._tile_ranges(starts)
    c_lo, c_hi = chunks if chunks is not None else (
        torch.zeros_like(num_chunks), num_chunks)
    pix = TCOMP._pixel_coords(fields.device)
    lane = torch.arange(TCOMP.CHUNK, device=fields.device)
    n_tiles = kw["ty"] * kw["tx"]
    total = torch.zeros((), dtype=torch.int64, device=fields.device)
    pairs = torch.zeros((), dtype=torch.int64, device=fields.device)
    for b0 in range(0, n_tiles, tile_batch):
        tiles = torch.arange(b0, min(b0 + tile_batch, n_tiles),
                             device=fields.device)
        tjf, py0 = TCOMP._tile_origin(tiles, kw["tx"], kw["height"])
        s, e, al = first[tiles], ends[tiles], aligned[tiles]
        lo, hi = c_lo[tiles], c_hi[tiles]
        for c in range(int(hi.max()) if tiles.numel() else 0):
            rows = al[:, None] + c * TCOMP.CHUNK + lane
            live = ((rows >= s[:, None]) & (rows < e[:, None])
                    & ((c >= lo) & (c < hi))[:, None])
            st = fields[:, rows.clamp(max=fields.shape[1] - 1)]
            g, _, _ = TCOMP._chunk_planes(lambda name: st[idx[name]][..., None],
                                          tjf, py0, pix, live[..., None])
            total += (g > 0).sum()
            pairs += live.sum()
    return int(total), int(pairs)


def tile_histogram(torch, starts):
    """Busy tiles, the fullest tile's pairs and index, and the mean pairs
    of a busy tile."""
    n = (starts[1:] - starts[:-1]).long()
    busy = n[n > 0]
    return {"tiles": int(n.numel()), "busy": int(busy.numel()),
            "fullest": int(n.max()), "fullest_tile": int(n.argmax()),
            "busy_mean": float(busy.float().mean()) if busy.numel() else 0.0}


def fullest_alone(torch, starts):
    """tile_starts with every tile but the fullest empty."""
    n = starts[1:] - starts[:-1]
    f = int(n.argmax())
    i = torch.arange(starts.shape[0], device=starts.device)
    return torch.where(i <= f, starts[f], starts[f + 1]).to(
        torch.int32).contiguous()


PTXAS_ENTRIES = (   # mangled-name piece -> kernel row
    ("texel_rows_kernel", "texel_rows"), ("fragment_kernel", "fragment_apply"),
    ("composite_kernelILb1E", "composite_albedo"),
    ("composite_kernelILb0E", "composite_full"),
    ("composite_bwd_kernelILb1E", "composite_bwd_albedo"),
    ("composite_bwd_kernelILb0E", "composite_bwd_full"),
    ("segment_state_kernelILb1E", "composite_bwd_state_albedo"),
    ("segment_state_kernelILb0E", "composite_bwd_state_full"),
    ("single_channel_kernelILb1E", "min_depth"),
    ("single_channel_kernelILb0E", "overdraw"))


def ptxas_resources(report):
    """{kernel row: (registers, spill store + load bytes, static shared
    bytes)} from build.report's -Xptxas -v lines (the largest over a
    kernel's instantiations)."""
    import re

    out, cur = {}, None
    for rep in report.values():
        for line in rep["ptxas"]:
            # a kernel's lines follow its "Compiling entry function" and
            # "Function properties" lines; a callee's follow its own
            # "Function properties" line and belong to no row
            m = re.search(r"(?:entry function '|Function properties for )"
                          r"'?([^' ]+)", line)
            if m:
                cur = next((row for piece, row in PTXAS_ENTRIES
                            if piece in m.group(1)), None)
                continue
            if cur is None:
                continue
            regs, spill, smem = out.get(cur, (0, 0, 0))
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m:
                spill = max(spill, int(m.group(1)) + int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                regs = max(regs, int(m.group(1)))
                m2 = re.search(r"(\d+) bytes smem", line)
                smem = max(smem, int(m2.group(1)) if m2 else 0)
            out[cur] = (regs, spill, smem)
    return out


def training_inputs(torch, TFIT, sp, mult, dev):
    """fit_splats' workload: the two 1080p views, the targets (render_rgb
    of the converted splats) and the start (the same splats with colours
    from numpy uniform noise, seed 0). The training loss renders splats in
    world units (SplatFormat.PLY_3DGS, as the JAX package's l2_loss does):
    the converted splats' scales times the conversion's sigma, as export_ply
    writes them."""
    from mesh2splat_torch.types import make_camera

    cams = [make_camera(e, [0, 0, 0], [0, 1, 0], np.pi / 3, W_PX, H_PX,
                        device=dev) for e in (EYE, EYE2)]
    sp_real = dataclasses.replace(sp, scale=sp.scale * mult)
    with torch.no_grad():
        targets = torch.stack([TFIT.render_rgb(sp_real, c, W_PX, H_PX)
                               for c in cams])
    noise = np.random.default_rng(0).uniform(0, 1, (sp.capacity, 3))
    start = dataclasses.replace(sp_real, color=torch.cat(
        [torch.from_numpy(noise.astype(np.float32)).to(dev),
         sp_real.color[:, 3:]], 1))
    return cams, targets, start


def training_paths(torch, kernels, TFIT, scene, sp, mult, proj_kw, cam,
                   pair_cap, dev):
    """Phase 3b: the training paths at full size, each with the launch
    counters zeroed before it and read after it. Returns their counts, the
    capture of the kernels' arguments and the time lines for phase 6."""
    from mesh2splat_torch.ops import conversion as TC
    from mesh2splat_torch.ops.projection import project_splats
    from mesh2splat_torch.render import binning as TB
    from mesh2splat_torch.render import tiled as TT
    from mesh2splat_torch.types import SplatFormat, make_camera

    paths, times = {}, []

    def run(name, fn, expect, renders):
        kernels.reset_launches()
        out = fn()
        sync()
        paths[name] = dict(kernels.launches)
        for k, n in expect.items():
            check(paths[name][k] == n, f"{name}: kernel {k} launched "
                  f"{paths[name][k]} times, expected {n}")
        dropped = [int(d) for d in watch.take()]
        check(len(dropped) == renders and not any(dropped),
              f"{name}: dropped pairs per render {dropped}, expected "
              f"{renders} renders with none dropped")
        log(f"{name}: launches {paths[name]}, {renders} renders with no "
            "dropped pairs")
        return out

    cams, targets, start = training_inputs(torch, TFIT, sp, mult, dev)
    fit_cfg = TFIT.FitConfig(steps=FIT_STEPS, lr=FIT_LR, width=W_PX,
                             height=H_PX, std_dev=mult)
    torch.cuda.reset_peak_memory_stats()
    with Capture(kernels) as cap, \
            Record(TB, "bin_pairs", lambda b: b.dropped_pairs) as watch:
        t0 = time.perf_counter()
        _, hist = run("fit_splats",
                      lambda: TFIT.fit_splats(start, cams, targets, fit_cfg),
                      {"composite_albedo": 2 * FIT_STEPS,
                       "composite_bwd_albedo": 2 * FIT_STEPS,
                       "composite_bwd_state_albedo": 2 * FIT_STEPS},
                      renders=2 * FIT_STEPS)
        fit_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"fit_splats: {sp.capacity} splats ({int(sp.count())} valid), 2 "
            f"views at {W_PX}x{H_PX}, {FIT_STEPS} steps in {fit_s:.2f} s, "
            f"history {hist}, peak memory {peak:.2f} GiB")
        check(all(np.isfinite(hist)) and hist[-1] < hist[0],
              f"fit_splats history {hist}")

        # fit_textures: the sphere's base colour from a flat grey start
        mesh, mat, pr = scene.primitives[0]
        lo, hi = mesh.bbox()
        cfg = TC.calibrate(mesh, lo, hi, TC.ConversionConfig(
            scene.last_config.resolution, 6))
        tcams = [make_camera(e, [0, 0, 0], [0, 1, 0], np.pi / 3, TEX_PX,
                             TEX_PX, device=dev) for e in (EYE, EYE2)]
        with torch.no_grad():
            sp_gt = TC.convert(mesh, mat, lo, hi, cfg)
            tex_targets = torch.stack([TFIT.render_rgb(
                sp_gt, c, TEX_PX, TEX_PX, std_dev=mult,
                splat_format=SplatFormat.MESH2SPLAT) for c in tcams])
        check([int(d) for d in watch.take()] == [0, 0],
              "fit_textures targets: dropped pairs")
        grey = dataclasses.replace(mat, base_color=torch.full_like(
            mat.base_color, 0.5))
        t0 = time.perf_counter()
        fitted, tex_hist = run(
            "fit_textures",
            lambda: TFIT.fit_textures(
                mesh, grey, cfg, tcams, tex_targets,
                TFIT.FitTexturesConfig(steps=TEX_STEPS, lr=5e-2,
                                       width=TEX_PX, height=TEX_PX)),
            {"texel_rows": TEX_STEPS, "fragment_apply": TEX_STEPS,
             "composite_albedo": 2 * TEX_STEPS,
             "composite_bwd_albedo": 2 * TEX_STEPS,
             "composite_bwd_state_albedo": 2 * TEX_STEPS},
            renders=2 * TEX_STEPS)
        tex_s = time.perf_counter() - t0
        tex = grey.base_color.clone().requires_grad_(True)
        sp_t = TC.convert(mesh, dataclasses.replace(grey, base_color=tex),
                          lo, hi, cfg)
        loss = torch.mean((TFIT.render_rgb(
            sp_t, tcams[0], TEX_PX, TEX_PX, std_dev=mult,
            splat_format=SplatFormat.MESH2SPLAT) - tex_targets[0]) ** 2)
        (g_tex,) = torch.autograd.grad(loss, [tex])
        check([int(d) for d in watch.take()] == [0],
              "fit_textures gradient: dropped pairs")
        log(f"fit_textures: {cfg.capacity} slots, 2 views at "
            f"{TEX_PX}x{TEX_PX}, "
            f"{TEX_STEPS} steps in {tex_s:.2f} s, history {tex_hist}, "
            f"texture gradient max |g| {float(g_tex.abs().max()):.3g}")
        check(all(np.isfinite(tex_hist))
              and bool(torch.isfinite(fitted.base_color).all()),
              f"fit_textures history {tex_hist}")
        check(bool(torch.isfinite(g_tex).all()) and bool(g_tex.any()),
              "fit_textures: texture gradient not finite or zero")

        # bench.py's gradient: mean of the 1080p albedo with respect to
        # pos, color, scale and quat
        def fwd(s):
            return TT.rasterize_tiled(project_splats(s, cam, **proj_kw),
                                      W_PX, H_PX, pair_capacity=pair_cap,
                                      albedo_only=True)["albedo"]

        def bench_grad():
            leaves = [t.detach().requires_grad_(True)
                      for t in (sp.pos, sp.color, sp.scale, sp.quat)]
            s2 = dataclasses.replace(sp, pos=leaves[0], color=leaves[1],
                                     scale=leaves[2], quat=leaves[3])
            return torch.autograd.grad(fwd(s2).mean(), leaves)

        grads = run("grad_albedo", bench_grad,
                    {"composite_albedo": 1, "composite_bwd_albedo": 1,
                     "composite_bwd_state_albedo": 1},
                    renders=1)
        check(all(bool(torch.isfinite(g).all()) for g in grads),
              "1080p gradient not finite")

        # the five-target loss of tests/test_tiled.py:114-120: the full
        # composite backward
        wgt = torch.from_numpy(np.random.default_rng(9).uniform(
            0, 1, (H_PX, W_PX, 4)).astype(np.float32)).to(dev)

        def grad_full():
            pos = sp.pos.detach().requires_grad_(True)
            color = sp.color.detach().requires_grad_(True)
            out = TT.rasterize_tiled(project_splats(
                dataclasses.replace(sp, pos=pos, color=color), cam,
                **proj_kw), W_PX, H_PX, pair_capacity=pair_cap)
            loss = ((out["albedo"] * wgt).sum()
                    + 0.3 * out["normal"][..., :3].sum()
                    + 0.2 * (out["position"][..., :3] * wgt[..., :3]).sum()
                    + 0.1 * out["depth"][..., 0].sum()
                    + 0.1 * out["metal_rough"][..., :2].sum())
            return torch.autograd.grad(loss, [pos, color])

        g_full = run("grad_full", grad_full,
                     {"composite_full": 1, "composite_bwd_full": 1,
                      "composite_bwd_state_full": 1},
                     renders=1)
        check(all(bool(torch.isfinite(g).all()) for g in g_full),
              "five-target gradient not finite")

    # times: the training step, through fit_splats' own budget, and
    # bench.py's forward / forward+backward
    params = TFIT.SplatParams.from_splats(start)
    opt = torch.optim.Adam(params.parameters(), lr=FIT_LR,
                           betas=TFIT.ADAM_BETAS, eps=TFIT.ADAM_EPS)
    step = TFIT.train_step_fn(
        opt, W_PX, H_PX, std_dev=mult,
        pair_capacity=TFIT.pair_budget(start, cams, W_PX, H_PX))
    step_ms = host_ms(lambda: step(params, start.valid, cams, targets), 3)
    with torch.no_grad():
        fwd_ms = host_ms(lambda: fwd(sp), 5)
    fb_ms = host_ms(bench_grad, 5)
    times.append(f"fit_splats step (2 views at {W_PX}x{H_PX}, "
                 f"{sp.capacity} splats): {step_ms:.2f} ms")
    times.append(f"1080p albedo forward {fwd_ms:.2f} ms, forward+backward "
                 f"{fb_ms:.2f} ms, bwd/fwd {(fb_ms - fwd_ms) / fwd_ms:.2f}, "
                 f"fwd+bwd / fwd {fb_ms / fwd_ms:.2f}")
    return {"paths": paths, "capture": cap, "times": times}


def render_paths(torch, kernels, scene, sp, img_albedo, img_final, dev):
    """Phase 3c: the render paths at full size on the converted sphere, each
    with the launch counters zeroed before it and read after it; no binning
    may drop a class-C pair. Returns their counts, the capture of the
    kernels' arguments and the time lines for phase 6."""
    from mesh2splat_torch.render import binning as TB
    from mesh2splat_torch.render import pipeline as TP
    from mesh2splat_torch.render.shadows import (
        _shadow_prep_fused, render_shadow_cubemap,
    )
    from mesh2splat_torch.types import RenderMode, make_camera

    mult = scene.last_config.scale_multiplier
    light = torch.tensor(BENCH_LIGHT, device=dev)
    far = torch.tensor(BENCH_FAR, device=dev)
    # bench.py's cubemap: the pair budget calibrated once, then fixed
    need = int(_shadow_prep_fused(sp, light, far, mult, SHADOW_PX)[2])
    shadow_cap = TB.round_pow2_budget(need)
    view = dict(eye=EYE, width=W_PX, height=H_PX, fov_deg=60.0)
    paths, times = {}, []

    def cubemap():
        return render_shadow_cubemap(sp, light, far, mult, size=SHADOW_PX,
                                     method="tiled", pair_capacity=shadow_cap,
                                     device=dev)

    def run(name, fn, expect, bins):
        kernels.reset_launches()
        out = fn()
        sync()
        paths[name] = dict(kernels.launches)
        for k, n in expect.items():
            check(paths[name][k] == n, f"{name}: kernel {k} launched "
                  f"{paths[name][k]} times, expected {n}")
        dropped = [int(d) for d in drops.take()]
        check(len(dropped) == bins and not any(dropped),
              f"{name}: dropped pairs per binning {dropped}, expected "
              f"{bins} binnings with none dropped")
        log(f"{name}: launches {paths[name]}, {bins} binnings with no "
            "dropped pairs")
        return out

    with Capture(kernels) as cap, \
            Record(TB, "bin_pairs", lambda b: b.dropped_pairs) as drops, \
            Record(TP, "pcf_shadow_factor") as shadow:
        cm = run("cubemap", cubemap, {"min_depth": 1}, bins=1)
        faces = cm.faces
        cov = (faces < 1.0).flatten(1).float().mean(1).tolist()
        log(f"cubemap {SHADOW_PX}^2 x 6 at light {BENCH_LIGHT}, far "
            f"{BENCH_FAR}: {need} class-C pairs needed (budget {shadow_cap}),"
            f" covered share per face {[round(c, 4) for c in cov]}")
        # the sphere lies towards -X, -Y and -Z from the light; no splat's
        # dominant direction is +X, +Y or +Z
        check(float(faces.min()) > 0.0 and float(faces.max()) <= 1.0,
              "cubemap values outside (0, 1]")
        check(cov[5] > 0.01 and cov[0] == cov[2] == cov[4] == 0.0,
              f"cubemap coverage per face {cov}")

        img_sh = run("final_shadows", lambda: scene.render(
            sp, mode=RenderMode.FINAL, shadows=True, **view),
            {"min_depth": 1, "composite_full": 1}, bins=2)
        (factor,) = shadow.take()
        share = float((factor > 0).float().mean())
        log(f"FINAL with shadows: {100 * share:.4f} % of pixels have a "
            f"shadow factor above 0; max brightening over the unshadowed "
            f"frame {float((img_sh - img_final).max()):.3g}")
        check(bool(torch.isfinite(img_sh).all()), "shadowed frame not finite")
        check(bool((img_sh <= img_final + 1e-6).all()),
              "the shadowed frame is brighter than the unshadowed one")

        img_od = run("overdraw", lambda: scene.render(
            sp, mode=RenderMode.OVERDRAW, **view), {"overdraw": 1}, bins=1)
        check(bool(torch.isfinite(img_od).all()) and float(img_od.max()) > 0,
              "OVERDRAW frame not finite or empty")
        log(f"OVERDRAW: max {float(img_od.max()):.4g} (= 0.01 x the deepest "
            f"count {float(img_od[..., 0].max()) / 0.01:.0f})")

        mesh, mat, _ = scene.primitives[0]
        cam = make_camera(EYE, [0, 0, 0], [0, 1, 0], np.pi / 3, W_PX, H_PX,
                          device=dev)
        fc = TP.calibrate_frame(sp, cam, TP.FrameConfig(
            W_PX, H_PX, RenderMode.ALBEDO,
            resolution_target=scene.last_config.resolution,
            depth_test_mesh=True))
        img_dt = run("depth_test", lambda: TP.render_frame(
            sp, cam, fc, mesh=mesh, material=mat), {"composite_full": 1},
            bins=1)
        check(bool(torch.isfinite(img_dt).all()) and float(img_dt.mean()) > 0.01,
              "depth-tested frame not finite or empty")

        img_sp = run("split", lambda: scene.render_split(sp, **view),
                     {"composite_full": 1}, bins=1)
        check(bool(torch.isfinite(img_sp).all())
              and bool((img_sp[:, W_PX // 2] == 1.0).all()),
              "split frame not finite or without its divider")
        left = img_sp[:, :W_PX // 2 - 2].mean()
        right = img_sp[:, W_PX // 2 + 2:].mean()
        log(f"depth test: mean |diff| to the untested ALBEDO frame "
            f"{float((img_dt - img_albedo).abs().mean()):.3g}"
            f"; split: mesh half mean {float(left):.4f}, splat half "
            f"{float(right):.4f}")

    t_cm = host_ms(cubemap, RENDER_CALLS)
    t_sh = host_ms(lambda: scene.render(sp, mode=RenderMode.FINAL,
                                        shadows=True, **view), RENDER_CALLS)
    t_od = host_ms(lambda: scene.render(sp, mode=RenderMode.OVERDRAW,
                                        **view), RENDER_CALLS)
    times.append(f"shadow cubemap {SHADOW_PX}^2 x 6 (bench.py's settings): "
                 f"{t_cm:.2f} ms; {W_PX}x{H_PX} FINAL with shadows "
                 f"{t_sh:.2f} ms; {W_PX}x{H_PX} OVERDRAW {t_od:.2f} ms")
    return {"paths": paths, "capture": cap, "times": times}


def training_card_vs_cpu(torch, TFIT, small, got, mult_small):
    """Phase 5's training part: one fit_splats loss and its gradients, and
    one fit_textures gradient, on the card and on the CPU (2k triangles,
    res 128, 160x120)."""
    from mesh2splat_torch.ops import conversion as TC
    from mesh2splat_torch.types import SplatFormat, make_camera

    losses, grads, tex_grads = {}, {}, {}
    noise = np.random.default_rng(0).uniform(0, 1, (got["cpu"][0].capacity,
                                                   3)).astype(np.float32)
    for d in ("cuda", "cpu"):
        s_sp = got[d][0]
        real = dataclasses.replace(s_sp, scale=s_sp.scale * mult_small)
        cams = [make_camera(e, [0, 0, 0], [0, 1, 0], np.pi / 3, 160, 120,
                            device=d) for e in ([0, 0.2, 3.0], EYE2)]
        with torch.no_grad():
            targets = torch.stack([TFIT.render_rgb(real, c, 160, 120)
                                   for c in cams])
        start = dataclasses.replace(real, color=torch.cat(
            [torch.from_numpy(noise).to(d), real.color[:, 3:]], 1))
        params = TFIT.SplatParams.from_splats(start)
        loss = TFIT.l2_loss(params, start.valid, cams, targets, 160, 120)
        loss.backward()
        losses[d] = float(loss.detach())
        grads[d] = {k: v.grad.cpu() for k, v in params.as_dict().items()
                    if v.grad is not None}

        sc = make_scene(small, d)
        mesh, mat, _ = sc.primitives[0]
        lo, hi = mesh.bbox()
        tex = mat.base_color.clone().requires_grad_(True)
        sp_t = TC.convert(mesh, dataclasses.replace(mat, base_color=tex),
                          lo, hi, TC.ConversionConfig(128, 6))
        img = TFIT.render_rgb(sp_t, cams[0], 160, 120, std_dev=mult_small,
                              splat_format=SplatFormat.MESH2SPLAT)
        (tex_grads[d],) = torch.autograd.grad((img ** 2).mean(), [tex])
    loss_rel = abs(losses["cuda"] - losses["cpu"]) / losses["cpu"]
    grad_rel = {k: float((grads["cuda"][k] - g).abs().max()
                         / g.abs().max().clamp(min=1e-30))
                for k, g in grads["cpu"].items()}
    g_c, g_p = tex_grads["cuda"].cpu(), tex_grads["cpu"]
    tex_rel = float((g_c - g_p).abs().max() / g_p.abs().max())
    log(f"card vs CPU training (2k tris, res 128, 2 views at 160x120): loss "
        f"{losses['cpu']:.6g}, relative diff {loss_rel:.3g}; gradients max "
        f"|diff| / max |grad| {grad_rel}; fit_textures texture gradient "
        f"{tex_rel:.3g}")
    check(loss_rel <= 1e-5 and max(grad_rel.values()) <= 1e-3
          and tex_rel <= 1e-3 and bool(g_p.any()),
          "card and CPU training differ")


def render_card_vs_cpu(torch, small, got, mult_small):
    """Phase 5's render part (2k triangles, res 128): the tiled cubemap at
    128^2 (K5), and at 160x120 the FINAL frame with shadows (a 512^2
    cubemap, which "auto" renders tiled), the OVERDRAW frame (K6), the
    depth-tested frame and the split screen, on the card and on the CPU."""
    from mesh2splat_torch.render import pipeline as TP
    from mesh2splat_torch.render.shadows import render_shadow_cubemap
    from mesh2splat_torch.types import RenderMode, make_camera

    out = {}
    for d in ("cuda", "cpu"):
        mesh, mat, _ = make_scene(small, d).primitives[0]
        s_sp = got[d][0]
        faces = render_shadow_cubemap(s_sp, BENCH_LIGHT, BENCH_FAR,
                                      mult_small, size=128, method="tiled",
                                      device=d).faces
        cam = make_camera([0, 0.2, 3.0], [0, 0, 0], [0, 1, 0], np.pi / 3,
                          160, 120, device=d)
        kw = dict(resolution_target=128)
        imgs = [TP.render_frame(s_sp, cam, TP.FrameConfig(
                    160, 120, RenderMode.FINAL, shadows=True, shadow_size=512,
                    **kw)),
                TP.render_frame(s_sp, cam, TP.FrameConfig(
                    160, 120, RenderMode.OVERDRAW, **kw)),
                TP.render_frame(s_sp, cam, TP.FrameConfig(
                    160, 120, depth_test_mesh=True, **kw), mesh=mesh,
                    material=mat),
                TP.render_split_screen(s_sp, mesh, mat, cam, TP.FrameConfig(
                    160, 120, **kw))]
        out[d] = [faces.cpu()] + [im.cpu() for im in imgs]
    (f_c, *i_c), (f_p, *i_p) = out["cuda"], out["cpu"]
    cov_c, cov_p = f_c < 1.0, f_p < 1.0
    agree = float((cov_c == cov_p).float().mean())
    both = cov_c & cov_p
    ddiff = float((f_c - f_p)[both].abs().max())
    idiff = [float((a - b).abs().max()) for a, b in zip(i_c, i_p)]
    log(f"card vs CPU renders (2k tris, res 128): cubemap 128^2 coverage "
        f"{float(cov_p.float().mean()):.4f}, agreeing on {agree:.6f} of "
        f"pixels, depth max |diff| {ddiff:.3g}; 160x120 FINAL+shadows, "
        f"OVERDRAW, depth-tested, split max |diff| "
        f"{[float(f'{x:.3g}') for x in idiff]}")
    check(float(cov_p.float().mean()) > 0.005 and agree >= 0.999
          and ddiff <= 1e-5 and max(idiff) <= 1e-3,
          "card and CPU renders differ")


def main():
    import torch

    # ---- 1. device ----------------------------------------------------
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False: this "
                 "smoke run needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}")
    dev = torch.device("cuda")

    from mesh2splat_torch import kernels
    from mesh2splat_torch.kernels import build
    from mesh2splat_torch.ops import fragment as TF
    from mesh2splat_torch.ops.projection import project_splats
    from mesh2splat_torch.io import ply
    from mesh2splat_torch.render import binning as TB
    from mesh2splat_torch.render import composite as TCOMP
    from mesh2splat_torch.render.tiled import rasterize_tiled
    from mesh2splat_torch.train import fit as TFIT
    from mesh2splat_torch.types import RenderMode, SplatFormat, make_camera

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    report = build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s for {len(report)} sources")
    for name, rep in report.items():
        log(f"  {name}.cu: {rep['seconds']:.1f} s"
            f"{' (cached)' if rep['cached'] else ''}")
        for line in rep["ptxas"]:
            log(f"    {line}")

    # ---- 3. the main path at full size ---------------------------------
    prim = synth_primitive()
    scene = make_scene(prim, dev)
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with Capture(kernels) as cap:
        sp, stats = scene.convert(resolution=512, layers=6,
                                  return_stats=True)
        count = int(sp.count())
        with tempfile.TemporaryDirectory() as tmp:
            for fmt in (0, 1, 2):
                path = os.path.join(tmp, f"splats_{fmt}.ply")
                scene.export_ply(sp, path, fmt=fmt)
                back, has_pbr = ply.read_ply(path)
                check(back["pos"].shape[0] == count,
                      f"PLY format {fmt}: {back['pos'].shape[0]} != {count}")
                check(has_pbr == (fmt in (1, 2)), f"PLY format {fmt} pbr")
        img_albedo = scene.render(sp, eye=EYE, width=W_PX, height=H_PX,
                                  fov_deg=60.0, mode=RenderMode.ALBEDO)
        img_final = scene.render(sp, eye=EYE, width=W_PX, height=H_PX,
                                 fov_deg=60.0, mode=RenderMode.FINAL)
        cam = make_camera(EYE, [0, 0, 0], [0, 1, 0], np.pi / 3, W_PX, H_PX,
                          device=dev)
        proj = project_splats(sp, cam, std_dev=scene.last_config
                              .scale_multiplier,
                              render_mode=RenderMode.ALBEDO,
                              splat_format=SplatFormat.MESH2SPLAT)
        pair_cap = TB.calibrate_overflow(proj, W_PX, H_PX)
        gb = rasterize_tiled(proj, W_PX, H_PX, pair_capacity=pair_cap,
                             albedo_only=True)
        sync()
    main_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    stats = {k: int(v) for k, v in stats.items()}
    log(f"main path: {main_s:.2f} s, splats {count} / capacity "
        f"{sp.capacity}, overflow {stats}, pairs {int(gb['num_pairs'])}, "
        f"dropped_pairs {int(gb['dropped_pairs'])}, peak memory "
        f"{peak_gib:.2f} GiB, launches {launches}")
    check(count > 1_000_000, f"splat count {count}")
    check(all(v == 0 for v in stats.values()), f"overflow {stats}")
    check(int(gb["dropped_pairs"]) == 0, "dropped pairs")
    for name, img in (("ALBEDO", img_albedo), ("FINAL", img_final)):
        check(tuple(img.shape) == (H_PX, W_PX, 3), f"{name} shape")
        check(bool(torch.isfinite(img).all()), f"{name} not finite")
        check(0.0 <= float(img.min()) and float(img.max()) <= 1.0 + 1e-6,
              f"{name} out of [0, 1]")
        check(float(img.mean()) > 0.01, f"{name} image is empty")
    check(bool(torch.isfinite(gb["albedo"]).all()), "raster not finite")
    for name in MAIN_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the main path")
    paths = {"main": launches}

    # ---- 3b. the training paths at full size ---------------------------
    mult = scene.last_config.scale_multiplier
    proj_kw = dict(std_dev=mult, render_mode=RenderMode.ALBEDO,
                   splat_format=SplatFormat.MESH2SPLAT)
    train = training_paths(torch, kernels, TFIT, scene, sp, mult, proj_kw,
                           cam, pair_cap, dev)
    paths.update(train["paths"])
    cap_t = train["capture"]
    log(f"device memory after the training paths: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")

    # ---- 3c. the render paths at full size ------------------------------
    renders = render_paths(torch, kernels, scene, sp, img_albedo, img_final,
                           dev)
    paths.update(renders["paths"])
    cap_r = renders["capture"]

    # ---- 4. kernels against their plain versions on the card ----------
    errs = {}
    (rec, meta), kw1 = cap.seen["texel_rows"]
    rows_k = kernels.texel_rows(rec, meta, **kw1)
    rows_p = TF.texel_rows_plain(rec, meta, **kw1)
    errs["texel_rows"] = int((rows_k - rows_p).abs().max())
    log(f"K1 texel_rows: {rec.shape[1]} records, {meta.shape[1]} slots, "
        f"{int((rows_k != rows_p).sum())} rows differ")
    check(errs["texel_rows"] == 0, "K1 differs from its plain version")

    (rec, taps, meta), kw2 = cap.seen["fragment_apply"]
    out_k = kernels.fragment_apply(rec, taps, meta, **kw2)
    out_p = TF.fragment_apply_plain(rec, taps, meta, **kw2)
    valid_eq = bool(torch.equal(out_k[19], out_p[19]))
    live = out_p[19] > 0
    errs["fragment_apply"] = float((out_k[:19, live] - out_p[:19, live])
                                   .abs().max())
    all_slots = float((out_k[:19] - out_p[:19]).abs().max())
    log(f"K2 fragment_apply: taps {tuple(taps.shape)} {taps.dtype}, valid "
        f"equal {valid_eq}, max |diff| {errs['fragment_apply']:.3g} on the "
        f"{int(live.sum())} live slots ({all_slots:.3g} over all slots)")
    check(valid_eq and errs["fragment_apply"] <= 2e-5,
          "K2 differs from its plain version")

    walked = {}
    k3_inputs = {}
    for variant in ("full", "albedo"):
        (fields, starts), kw3 = cap.seen[f"composite_forward_{variant}"]
        k3_inputs[variant] = (fields, starts, kw3)
        w = torch.empty(starts.shape[0] - 1, dtype=torch.int32, device=dev)
        img_k = kernels.composite_forward(fields, starts, walked=w, **kw3)
        img_p, w_p = TCOMP.composite_plain(fields, starts, kw3["height"],
                                           kw3["ty"], kw3["tx"],
                                           kw3["albedo_only"], tile_batch=512,
                                           return_walked=True)
        walked[variant] = w
        same = bool(torch.equal(w, w_p))
        errs[f"composite_{variant}"] = float((img_k - img_p).abs().max())
        log(f"K3 composite {variant}: {kw3['ty'] * kw3['tx']} tiles, "
            f"{int(starts[-1])} pairs ({int(w.sum())} walked before the "
            f"early exits, equal to the plain version's tile for tile: "
            f"{same}), max |diff| {errs[f'composite_{variant}']:.3g} over all "
            f"tiles; tiles {tile_histogram(torch, starts)}")
        check(errs[f"composite_{variant}"] <= 1e-3 and same,
              f"K3 {variant} differs from its plain version")

    k4_inputs, covered, k4_plain_ms = {}, {}, {}
    log(f"device memory before the K4 comparison: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    for variant in ("albedo", "full"):
        (fields, starts, ct, res), kw4 = cap_t.seen[
            f"composite_backward_{variant}"]
        # the captured fields belong to the training graph: hold them alone
        fields = fields.detach()
        k4_inputs[variant] = (fields, starts, ct, res, kw4)
        d_k = kernels.composite_backward(fields, starts, ct, res, **kw4)
        out = kernels.composite_forward(
            fields, starts, height=kw4["height"], ty=kw4["ty"],
            tx=kw4["tx"], albedo_only=kw4["albedo_only"])
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        d_p = TCOMP.composite_backward_plain(
            fields, starts, out, ct, kw4["height"], kw4["ty"], kw4["tx"],
            kw4["albedo_only"], tile_batch=32)
        e1.record()
        e1.synchronize()
        k4_plain_ms[variant] = e0.elapsed_time(e1)
        covered[variant] = covered_pairs(torch, fields, starts, kw4,
                                         variant)[0]
        nf = len(TB.VARIANT_FIELDS[variant])
        scale = float(d_p.abs().max())
        err = float((d_k - d_p).abs().max())
        # each row against 1e-3 of its own largest |d|: the rows differ in
        # scale by orders of magnitude (mean and conic against colour)
        row_err = (d_k - d_p)[:nf].abs().amax(1)
        row_scale = d_p[:nf].abs().amax(1)
        row_rel = row_err / row_scale.clamp(min=1e-30)
        errs[f"composite_bwd_{variant}"] = err
        errs[f"composite_bwd_{variant}_rel"] = float(row_rel.max())
        again = kernels.composite_backward(fields, starts, ct, res, **kw4)
        rerun_equal = bool(torch.equal(d_k, again))
        log(f"K4 composite backward {variant}: {kw4['ty'] * kw4['tx']} "
            f"tiles, {int(starts[-1])} pairs, {covered[variant]} covered "
            f"(pair, pixel), max |diff| {err:.3g} of max |dfields| "
            f"{scale:.3g}; per row max |diff| / max |d| "
            f"{[float(f'{r:.3g}') for r in row_rel.tolist()]}, padding rows "
            f"zero {not bool(d_k[nf:].any())}, a second run bit-equal "
            f"{rerun_equal}; tiles {tile_histogram(torch, starts)}")
        check(bool((row_err <= 1e-3 * row_scale).all())
              and not bool(d_k[nf:].any()) and rerun_equal,
              f"K4 {variant} differs from its plain version")
        # the state pass against its plain version, on the rows the main
        # pass reads (every segment but a tile's last)
        st_k, _ = kernels.composite_bwd_states(fields, starts, ct, **kw4)
        e0.record()
        st_p, last = TCOMP.segment_states_plain(
            fields, starts, ct, kw4["height"], kw4["ty"], kw4["tx"],
            kw4["albedo_only"], kernels.seg_chunks(), tile_batch=32)
        e1.record()
        e1.synchronize()
        k4_plain_ms[f"state_{variant}"] = e0.elapsed_time(e1)
        keep = ~last
        st_diff = (st_k[:st_p.shape[0]][keep] - st_p[keep]).abs().amax(
            dim=(0, 2))
        st_scale = st_p[keep].abs().amax(dim=(0, 2)).clamp(min=1.0)
        errs[f"composite_bwd_state_{variant}"] = float(st_diff.max())
        errs[f"composite_bwd_state_{variant}_rel"] = float(
            (st_diff / st_scale).max())
        log(f"K4 state pass {variant}: {int(keep.sum())} of "
            f"{st_p.shape[0]} segments' states, max |diff| per state "
            f"{[float(f'{d:.3g}') for d in st_diff.tolist()]} (of max "
            f"{[float(f'{d:.3g}') for d in st_scale.tolist()]})")
        check(bool((st_diff <= 1e-4 * st_scale).all()),
              f"K4 {variant} state pass differs from its plain version")

    k56_inputs, k56_plain_ms = {}, {}
    for name, plain in (("min_depth", TCOMP.min_depth_plain),
                        ("overdraw", TCOMP.overdraw_plain)):
        (fields, starts), kw5 = cap_r.seen[name]
        k56_inputs[name] = (fields, starts, kw5)
        got_k = getattr(kernels, name)(fields, starts, **kw5)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        ref_p = plain(fields, starts, kw5["height"], kw5["ty"], kw5["tx"],
                      tile_batch=512)
        e1.record()
        e1.synchronize()
        k56_plain_ms[name] = e0.elapsed_time(e1)
        equal = bool(torch.equal(got_k, ref_p))
        errs[name] = float((got_k - ref_p).abs().max())
        per_tile = starts[1:] - starts[:-1]
        log(f"{'K5' if name == 'min_depth' else 'K6'} {name}: "
            f"{kw5['ty'] * kw5['tx']} tiles ({int((per_tile > 0).sum())} "
            f"with pairs, the fullest {int(per_tile.max())}), "
            f"{int(starts[-1])} pairs, "
            f"{int((got_k != ref_p).sum())} pixels differ (max |diff| "
            f"{errs[name]:.3g}), equal to the plain version: {equal}")
        check(equal, f"{name} differs from its plain version")

    # ---- 5. the slice on the card vs the same code on the CPU ----------
    small = synth_primitive(2_000, tex=128, seed=1)
    got = {}
    for d in ("cuda", "cpu"):
        sc = make_scene(small, d)
        s_sp = sc.convert(resolution=128, layers=6)
        img = sc.render(s_sp, eye=[0, 0.2, 3.0], width=160, height=120,
                        mode=RenderMode.ALBEDO)
        got[d] = (s_sp, img.cpu())
    a, b = got["cuda"][0], got["cpu"][0]
    va, vb = a.valid.cpu(), b.valid
    check(int(a.count()) == int(b.count()) and torch.equal(va, vb),
          "card and CPU convert differ in count or valid")
    sdiff = max(float((getattr(a, f).cpu() - getattr(b, f))[vb].abs().max())
                for f in ("pos", "color", "scale", "normal", "quat", "pbr"))
    idiff = float((got["cuda"][1] - got["cpu"][1]).abs().max())
    log(f"card vs CPU (2k tris, res 128, 160x120): count {int(b.count())} "
        f"equal, splats max |diff| {sdiff:.3g}, image max |diff| {idiff:.3g}")
    check(sdiff <= 2e-5 and idiff <= 1e-3, "card and CPU slices differ")
    training_card_vs_cpu(torch, TFIT, small, got, mult_small=1.0 / 128)
    render_card_vs_cpu(torch, small, got, mult_small=1.0 / 128)

    # ---- 6. times --------------------------------------------------------
    conv_ms = host_ms(lambda: scene.convert(resolution=512, layers=6), 10)
    render_ms = host_ms(lambda: scene.render(
        sp, eye=EYE, width=W_PX, height=H_PX, fov_deg=60.0,
        mode=RenderMode.ALBEDO), 5)
    log(f"conversion {conv_ms:.2f} ms/mesh ({1e3 / conv_ms:.1f} conv/s), "
        f"1080p ALBEDO render {render_ms:.2f} ms ({smi})")

    n_tri = prim.tri_pos.shape[0]
    (rec, meta), kw1 = cap.seen["texel_rows"]
    (rec2, taps, meta2), kw2 = cap.seen["fragment_apply"]
    cap_slots = meta.shape[1]
    resources = ptxas_resources(report)
    rows = []

    def entry(name, source, replaces, ms, plain_ms, nbytes, nops, err,
              path="main", rel_err=None, walk_ops=None, fullest_ms=None):
        """One kernel's row. Its bound: the larger of the bytes it must move
        and, per kind of operation, the f32 operations the function needs
        on this run's data (per pair, and per (pair, pixel) the pair
        covers); walk_ms the same with the naive walk's operations (every
        (pair, pixel) of a walked chunk), the bound the first kernels
        were held to."""
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / F32_FLOPS_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        walk = max(t_bytes, (walk_ops if walk_ops is not None else nops)
                   / F32_FLOPS_PER_S * 1e3)
        regs, spill, smem = resources.get(name, (None, None, None))
        warps = (8 * kernels.resident_blocks(name)
                 if name.startswith("composite") else None)
        rows.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=paths[path][name], path=path,
            launches_per_main_path=launches[name],
            launches_per_training_step=(paths["fit_splats"][name]
                                        / FIT_STEPS),
            launches_per_texture_step=(paths["fit_textures"][name]
                                       / TEX_STEPS),
            max_abs_err=err, max_rel_err=rel_err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound,
            bound_us=bound * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            walk_ms=walk, fullest_tile_ms=fullest_ms, registers=regs,
            spill_bytes=spill, static_smem_bytes=smem,
            resident_warps_per_sm=warps,
            library_ms=None))

    entry("texel_rows", "mesh2splat_torch/kernels/csrc/texel_rows.cu",
          "mesh2splat_tpu/ops/fragment.py:597",
          event_ms(lambda: kernels.texel_rows(rec, meta, **kw1), 20),
          event_ms(lambda: TF.texel_rows_plain(rec, meta, **kw1), 20),
          24 * n_tri * 4 + 4 * cap_slots * 4 + cap_slots * 4,
          cap_slots * 150, errs["texel_rows"])
    entry("fragment_apply", "mesh2splat_torch/kernels/csrc/fragment.cu",
          "mesh2splat_tpu/ops/fragment.py:674",
          event_ms(lambda: kernels.fragment_apply(rec2, taps, meta2, **kw2),
                   20),
          event_ms(lambda: TF.fragment_apply_plain(rec2, taps, meta2, **kw2),
                   20),
          58 * n_tri * 4 + taps.numel() * 4 + 4 * cap_slots * 4
          + 20 * cap_slots * 4,
          cap_slots * 400, errs["fragment_apply"])
    # Operations, one rule for K3-K6: per pair the conic's axes and the
    # plane coefficients (~60; K4 ~100 with the chain to the mean and conic
    # rows), and per covered (pair, pixel) the coverage test (the falloff
    # polynomial 10, the quad's u and v 8, the test 4: 22) plus the terms
    # the kernel computes there, counted from its arithmetic: K3 15 albedo /
    # 39 full (falloff, chains, accumulations), K4 48 / 98, K4's state pass
    # 17 / 41, K5 and K6 3. The naive walk (walk_ms) counts the 22 at every
    # (pair, pixel) of a walked chunk instead.
    for variant, n_fields, per_px in (("full", 18, 39), ("albedo", 9, 15)):
        fields, starts, kw3 = k3_inputs[variant]
        pairs = int(starts[-1])
        ty, tx = kw3["ty"], kw3["tx"]
        w = walked[variant].long()
        first, _, aligned, _ = TCOMP._tile_ranges(starts)
        hi = torch.where(w > 0, torch.div(first + w - aligned + 127, 128,
                                          rounding_mode="floor"), 0)
        cov, n_walked = covered_pairs(torch, fields, starts, kw3, variant,
                                      (torch.zeros_like(hi), hi))
        nbytes = (n_fields * pairs * 4 + (ty * tx + 1) * 4
                  + 16 * ty * 32 * tx * 32 * 4)
        alone = fullest_alone(torch, starts)
        entry(f"composite_{variant}",
              "mesh2splat_torch/kernels/csrc/composite.cu",
              "mesh2splat_tpu/render/composite.py:351",
              event_ms(lambda: kernels.composite_forward(fields, starts,
                                                         **kw3), 20),
              event_ms(lambda: TCOMP.composite_plain(
                  fields, starts, kw3["height"], ty, tx, kw3["albedo_only"],
                  tile_batch=512), 3, warm=1),
              nbytes, n_walked * 60 + cov * (22 + per_px),
              errs[f"composite_{variant}"],
              walk_ops=n_walked * (1024 * 22 + 60),
              fullest_ms=event_ms(lambda: kernels.composite_forward(
                  fields, alone, **kw3), 20))
        log(f"K3 {variant}: {n_walked} pairs walked, {cov} covered "
            f"(pair, pixel) in the walked chunks")
    for variant, n_fields, per_px, per_px_state in (("albedo", 9, 48, 17),
                                                    ("full", 18, 98, 41)):
        fields, starts, ct, res, kw4 = k4_inputs[variant]
        pairs = int(starts[-1])
        ty, tx = kw4["ty"], kw4["tx"]
        n_ct = 4 if kw4["albedo_only"] else 14
        n_res = 1 if kw4["albedo_only"] else 2
        px_bytes = ty * 32 * tx * 32 * 4
        nbytes = (n_fields * pairs * 4 + (ty * tx + 1) * 4
                  + (n_ct + n_res) * px_bytes + fields.numel() * 4)
        alone = fullest_alone(torch, starts)
        # the whole backward: its state pass and its main pass
        entry(f"composite_bwd_{variant}",
              "mesh2splat_torch/kernels/csrc/composite_bwd.cu",
              "mesh2splat_tpu/render/composite.py:501",
              event_ms(lambda: kernels.composite_backward(
                  fields, starts, ct, res, **kw4), 10),
              k4_plain_ms[variant], nbytes,
              pairs * 100 + covered[variant] * (22 + per_px),
              errs[f"composite_bwd_{variant}"],
              path="fit_splats" if variant == "albedo" else "grad_full",
              rel_err=errs[f"composite_bwd_{variant}_rel"],
              walk_ops=pairs * (1024 * 22 + 100) + covered[variant] * per_px,
              fullest_ms=event_ms(lambda: kernels.composite_backward(
                  fields, alone, ct, res, **kw4), 10))
        # the state pass alone: every segment but a tile's last
        seg = kernels.seg_chunks()
        seg_first = kernels.segment_table(starts, seg).long()
        nseg = seg_first[1:] - seg_first[:-1]
        hi = (nseg - 1).clamp(min=0) * seg
        cov, n_state = covered_pairs(torch, fields, starts, kw4, variant,
                                     (torch.zeros_like(hi), hi))
        n_states = int((nseg - 1).clamp(min=0).sum())
        entry(f"composite_bwd_state_{variant}",
              "mesh2splat_torch/kernels/csrc/composite_bwd.cu",
              "mesh2splat_tpu/render/composite.py:501",
              event_ms(lambda: kernels.composite_bwd_states(
                  fields, starts, ct, **kw4), 10),
              k4_plain_ms[f"state_{variant}"],
              n_fields * n_state * 4 + (ty * tx + 1) * 4 + n_ct * px_bytes
              + n_states * (2 if kw4["albedo_only"] else 4) * 1024 * 4,
              n_state * 60 + cov * (22 + per_px_state),
              errs[f"composite_bwd_state_{variant}"],
              path="fit_splats" if variant == "albedo" else "grad_full",
              rel_err=errs[f"composite_bwd_state_{variant}_rel"],
              walk_ops=n_state * (1024 * 22 + 60))
        log(f"K4 {variant}: state pass over {n_state} pairs in {n_states} "
            f"segments ({seg} chunks each), {cov} covered "
            f"(pair, pixel)")
    for name, variant, n_fields, line in (("min_depth", "depth", 6, 784),
                                          ("overdraw", "overdraw", 5, 833)):
        fields, starts, kw5 = k56_inputs[name]
        pairs = int(starts[-1])
        ty, tx = kw5["ty"], kw5["tx"]
        cov, _ = covered_pairs(torch, fields, starts, kw5, variant)
        entry(name, "mesh2splat_torch/kernels/csrc/single_channel.cu",
              f"mesh2splat_tpu/render/composite.py:{line}",
              event_ms(lambda: getattr(kernels, name)(fields, starts, **kw5),
                       10),
              k56_plain_ms[name],
              n_fields * pairs * 4 + (ty * tx + 1) * 4
              + ty * 32 * tx * 32 * 4,
              pairs * 60 + cov * (22 + 3), errs[name],
              path="cubemap" if name == "min_depth" else "overdraw",
              walk_ops=pairs * (1024 * 22 + 60))
    for r in rows:
        log(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.3f} ms,"
            f" bound {r['bound_ms']:.4f} ms by {r['bound_by']}, naive walk "
            f"{r['walk_ms']:.4f} ms, {r['launches']} launches on the "
            f"{r['path']} path, {r['launches_per_training_step']:g} per "
            f"fit_splats step, {r['launches_per_texture_step']:g} per "
            f"fit_textures step; {r['registers']} registers, "
            f"{r['spill_bytes']} spill bytes, {r['static_smem_bytes']} static "
            f"shared bytes, {r['resident_warps_per_sm']} resident warps/SM"
            + (f"; fullest tile alone {r['fullest_tile_ms']:.4f} ms"
               if r["fullest_tile_ms"] is not None else "") + ")")
    for line in train["times"] + renders["times"]:
        log(f"{line} ({smi})")

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
