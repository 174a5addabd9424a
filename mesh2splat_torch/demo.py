"""Demo of the port (counterpart of ``examples/demo.py``): build a textured
cube GLB, convert it, render every visualization mode, relight with shadows,
compare mesh and splats side by side and round-trip a PLY.

Run:  python -m mesh2splat_torch.demo [--device cpu] [outdir]
      python -m mesh2splat_torch.demo --turntable 60 [--device cpu] [outdir]

outdir defaults to build/demo/ of the checkout. --turntable N is the app
frame loop the reference runs interactively (main.cpp:36-59): N frames of a
FlyCamera orbit through render_frame into an image sequence, with
FrameTimer's rolling frame-time average printed per frame like the UI plot
(renderer.cpp:147-175, ImGuiUI.cpp:267-311; the 16.6 ms line is the
reference's interactive target, ImGuiUi.hpp:185).
"""

from __future__ import annotations

import argparse
import io
import pathlib
import time

import numpy as np
import torch

from .io import gltf, ply
from .ops.conversion import ConversionConfig, convert
from .render.lighting import PointLight
from .render.pipeline import (
    FrameConfig, calibrate_frame, render_frame, render_split_screen,
)
from .types import RenderMode, make_camera
from .utils.camera_controller import FlyCamera
from .utils.profiling import FrameTimer

DEFAULT_OUT = pathlib.Path(__file__).resolve().parents[1] / "build" / "demo"
CUBE_CONFIG = ConversionConfig(resolution=96, layers=8, gaussian_std=1.3)


def make_cube_glb(path):
    """A 12-triangle cube with a 128^2 checker base-colour texture."""
    from PIL import Image

    verts, tris = [], []
    for axis in range(3):
        for s in (-0.5, 0.5):
            base = len(verts)
            for cu, cv in [(0, 0), (1, 0), (1, 1), (0, 1)]:
                p = [0.0, 0.0, 0.0]
                p[axis] = s
                p[(axis + 1) % 3] = cu - 0.5
                p[(axis + 2) % 3] = cv - 0.5
                verts.append(p)
            order = [[0, 1, 2], [0, 2, 3]] if s > 0 else [[0, 2, 1], [0, 3, 2]]
            tris += [[base + i for i in t] for t in order]
    v = np.asarray(verts, np.float32)
    f = np.asarray(tris, np.uint32)

    tex = np.zeros((128, 128, 4), np.uint8)
    yy, xx = np.indices((128, 128))
    checker = ((yy // 16 + xx // 16) % 2).astype(np.float32)
    tex[..., 0] = (80 + 140 * checker).astype(np.uint8)
    tex[..., 1] = (60 + 60 * (1 - checker)).astype(np.uint8)
    tex[..., 2] = 160
    tex[..., 3] = 255
    buf = io.BytesIO()
    Image.fromarray(tex).save(buf, format="PNG")

    gltf.write_glb(
        path, v, f, uvs=(v[:, :2] + 0.5), base_color_png=buf.getvalue(),
        metallic_factor=0.4, roughness_factor=0.5,
    )


def save(img, path):
    from PIL import Image

    arr = torch.clamp(img, 0, 1).cpu().numpy()
    Image.fromarray((arr * 255).astype(np.uint8)).save(path)
    print(f"  wrote {path}")


def load_cube(out: pathlib.Path, device):
    """Write the cube GLB into ``out`` and convert it: (mesh, material,
    splats)."""
    out.mkdir(parents=True, exist_ok=True)
    glb_path = out / "cube.glb"
    make_cube_glb(glb_path)
    prim = gltf.load_glb(glb_path)[0]
    mesh, mat = gltf.to_device(prim, device)
    lo, hi = (mesh.tri_pos.new_tensor(b) for b in prim.bbox())
    splats = convert(mesh, mat, lo, hi, CUBE_CONFIG)
    print(f"converted: {int(splats.count())} gaussians")
    return mesh, mat, splats


def turntable(n_frames: int, out: pathlib.Path, device="cuda",
              size: int = 256):
    """The reference's interactive frame loop, offline: per frame the
    FlyCamera moves on an orbit aimed at the centre (a user's strafe plus
    mouse-look), render_frame draws, FrameTimer reports the rolling average
    with deferred synchronization (10 samples, read 5 frames late). Returns
    the timer."""
    _, _, splats = load_cube(out, device)
    cfg = CUBE_CONFIG
    fc = FrameConfig(width=size, height=size, render_mode=RenderMode.ALBEDO,
                     gaussian_std=cfg.gaussian_std,
                     resolution_target=cfg.resolution)
    radius = 2.4
    cam_ctl = FlyCamera.create(position=(0.0, 0.9, radius))
    cam_ctl.pitch_deg = -20.0
    fc = calibrate_frame(splats, cam_ctl.camera(size, size, device), fc)

    timer = FrameTimer()
    seq_dir = out / "turntable"
    seq_dir.mkdir(exist_ok=True)
    t_prev = time.perf_counter()
    for i in range(n_frames):
        ang = 2.0 * np.pi * i / max(n_frames, 1)
        cam_ctl.position = np.asarray(
            [radius * np.sin(ang), 0.9, radius * np.cos(ang)])
        cam_ctl.yaw_deg = -90.0 - np.rad2deg(ang)
        img = render_frame(splats, cam_ctl.camera(size, size, device), fc)
        ms = timer.frame(img)
        save(img, seq_dir / f"frame_{i:04d}.png")
        now = time.perf_counter()
        dt, t_prev = now - t_prev, now
        print(f"frame {i:3d}: wall {dt * 1e3:7.1f} ms"
              + (f", frame avg {timer.average_ms:7.1f} ms (newest {ms:.1f}; "
                 f"{'<=' if timer.average_ms <= 16.6 else '>'} 16.6 ms "
                 "target)" if ms is not None else " (timer warming up)"))
    if timer.average_ms is not None:
        print(f"turntable done: {n_frames} frames, rolling avg "
              f"{timer.average_ms:.1f} ms")
    return timer


def demo(out: pathlib.Path, device="cuda"):
    mesh, mat, splats = load_cube(out, device)
    cfg = CUBE_CONFIG
    cam = make_camera(eye=[1.4, 1.0, 1.6], center=[0, 0, 0], up=[0, 1, 0],
                      fov_y_rad=np.pi / 3, width=256, height=256,
                      device=device)
    light = PointLight(position=torch.tensor([2.0, 3.0, 2.0], device=device),
                       color=torch.ones(3, device=device), intensity=9.0)

    for mode in (RenderMode.ALBEDO, RenderMode.NORMAL, RenderMode.DEPTH,
                 RenderMode.PBR, RenderMode.FINAL):
        fc = FrameConfig(width=256, height=256, render_mode=mode,
                         gaussian_std=cfg.gaussian_std,
                         resolution_target=cfg.resolution, use_tiled=False,
                         shadows=(mode == RenderMode.FINAL), shadow_size=128)
        save(render_frame(splats, cam, fc, light=light),
             out / f"cube_{mode.name.lower()}.png")

    fc = FrameConfig(width=256, height=256, render_mode=RenderMode.ALBEDO,
                     gaussian_std=cfg.gaussian_std,
                     resolution_target=cfg.resolution, use_tiled=False)
    save(render_split_screen(splats, mesh, mat, cam, fc, light=light),
         out / "cube_split.png")

    ply.write_ply(out / "cube.ply", ply.splats_to_arrays(splats), fmt=1,
                  scale_multiplier=cfg.scale_multiplier)
    back, has_pbr = ply.read_ply(out / "cube.ply")
    print(f"  PLY round trip: {back['pos'].shape[0]} splats, pbr={has_pbr}")
    print("demo complete:", out)


def main(argv=None):
    p = argparse.ArgumentParser(prog="mesh2splat_torch.demo")
    p.add_argument("outdir", nargs="?", default=str(DEFAULT_OUT))
    p.add_argument("--turntable", type=int, default=None, metavar="N")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    out = pathlib.Path(args.outdir)
    if args.turntable is not None:
        turntable(args.turntable, out, args.device)
    else:
        demo(out, args.device)


if __name__ == "__main__":
    main()
