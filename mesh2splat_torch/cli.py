"""Command-line interface of the port: convert / render / batch (counterpart
of ``mesh2splat_tpu.cli``, with the same commands and options and one more,
``--device``).

The reference's closest equivalent is the ImGui batch-conversion queue
(reference: src/imGuiUi/ImGuiUI.cpp:550-615 enqueueFolder/popNextBatchItem +
the mediator's Idle->Loading->Converting->Exporting state machine,
guiRendererConcreteMediator.cpp:146-251).

All three commands go through the port's Scene, so conversion always runs
the calibrated path and reports its budget overflow counters (scenes of
several primitives take the fused convert_packed pass). Everything runs on
``--device`` (default cuda; ``--device cpu`` runs the kernels' plain
PyTorch versions).

Usage:
  python -m mesh2splat_torch.cli convert in.glb out.ply [--resolution 512]
      [--format 0|1|2] [--std 1.0] [--layers 6] [--device cuda]
  python -m mesh2splat_torch.cli render in.{glb,ply} out.png [--mode final]
      [--width 1280] [--height 720] [--eye x,y,z] [--shadows] [--split X]
  python -m mesh2splat_torch.cli batch in_dir out_dir [--resolution 512] ...
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time


def _build_parser():
    p = argparse.ArgumentParser(prog="mesh2splat_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--resolution", type=int, default=512,
                        help="conversion resolutionTarget (16..4096)")
        sp.add_argument("--layers", type=int, default=6,
                        help="overlap budget per texel (capacity = res^2 * layers)")
        sp.add_argument("--std", type=float, default=1.0,
                        help="gaussian std slider value 0.1..2.0")
        sp.add_argument("--format", type=int, default=0, choices=(0, 1, 2),
                        help="PLY format: 0=3DGS, 1=PBR, 2=compressed PBR")
        sp.add_argument("--device", default="cuda",
                        help="torch device to run on (cuda, or cpu)")

    c = sub.add_parser("convert", help="glb -> splat PLY")
    c.add_argument("input")
    c.add_argument("output")
    common(c)

    r = sub.add_parser("render", help="glb or ply -> image")
    r.add_argument("input")
    r.add_argument("output")
    common(r)
    r.add_argument("--mode", default="albedo",
                   choices=("albedo", "depth", "normal", "geometry",
                            "overdraw", "pbr", "final"))
    r.add_argument("--width", type=int, default=1280)
    r.add_argument("--height", type=int, default=720)
    r.add_argument("--eye", default="0,0,3")
    r.add_argument("--center", default="0,0,0")
    r.add_argument("--fov", type=float, default=60.0)
    r.add_argument("--light", default="2,2,2")
    r.add_argument("--shadows", action="store_true")
    # per-model transform (the reference's gizmo panel -> UpdateTransforms)
    r.add_argument("--translate", default=None, metavar="X,Y,Z")
    r.add_argument("--rotate", default=None, metavar="QW,QX,QY,QZ")
    r.add_argument("--scale-model", default=None, metavar="SX,SY,SZ")
    # split-screen mesh-vs-splat compare (the reference's stencil divider,
    # GaussianRelightingPass.cpp:90-135); GLB inputs only
    r.add_argument("--split", type=float, default=None, metavar="X",
                   help="split-screen compare: mesh left of X in [0,1], "
                        "splats right (glb input only)")

    b = sub.add_parser("batch", help="convert every .glb in a folder")
    b.add_argument("input_dir")
    b.add_argument("output_dir")
    common(b)
    return p


def _convert_scene(path, args):
    """Load and convert through Scene.convert: the calibrated path with its
    overflow counters. Returns (scene, splats, {counter: dropped})."""
    from .scene import Scene

    scene = Scene.from_glb(path, device=args.device)
    splats, stats = scene.convert(
        resolution=args.resolution, layers=args.layers,
        gaussian_std=args.std, calibrated=True, return_stats=True,
    )
    dropped = {k: int(v) for k, v in stats.items()}
    return scene, splats, dropped


def _report_drops(path, dropped):
    total = sum(dropped.values())
    if total:
        detail = ", ".join(f"{k}={v}" for k, v in dropped.items() if v)
        print(f"WARNING {path}: {total} splats dropped to budget ({detail}); "
              f"raise --layers to recover them", file=sys.stderr)
    return total


def cmd_convert(args):
    t0 = time.perf_counter()
    scene, splats, dropped = _convert_scene(args.input, args)
    count = int(splats.count())
    _report_drops(args.input, dropped)
    scene.export_ply(splats, args.output, fmt=args.format)
    nbytes = pathlib.Path(args.output).stat().st_size
    dt = time.perf_counter() - t0
    print(f"{args.input} -> {args.output}: {count} gaussians, "
          f"dropped {sum(dropped.values())}, "
          f"{nbytes / 1e6:.1f} MB, {dt * 1e3:.0f} ms")


def _vec(s, default):
    return tuple(float(x) for x in s.split(",")) if s else default


def cmd_render(args):
    import numpy as np
    import torch
    from PIL import Image

    from .render.lighting import PointLight
    from .scene import Scene
    from .types import RenderMode

    mode = RenderMode[args.mode.upper()]
    suffix = pathlib.Path(args.input).suffix.lower()

    model_transform = None
    if args.translate or args.rotate or args.scale_model:
        model_transform = (
            _vec(args.translate, (0, 0, 0)),
            _vec(args.rotate, (1, 0, 0, 0)),
            _vec(args.scale_model, (1, 1, 1)),
        )

    # flag combinations are checked before the load and conversion
    if args.split is not None:
        if suffix == ".ply":
            raise SystemExit("--split needs a glb input (mesh to compare)")
        if args.shadows or model_transform is not None:
            raise SystemExit(
                "--split cannot be combined with --shadows/--translate/"
                "--rotate/--scale-model"
            )

    if suffix == ".ply":
        scene = Scene.from_ply(args.input, device=args.device)
        splats = scene.imported_splats
    else:
        scene, splats, dropped = _convert_scene(args.input, args)
        _report_drops(args.input, dropped)

    eye = [float(x) for x in args.eye.split(",")]
    center = [float(x) for x in args.center.split(",")]
    dev = splats.device
    light = PointLight(
        position=torch.tensor([float(x) for x in args.light.split(",")],
                              device=dev),
        color=torch.ones(3, device=dev), intensity=10.0)

    if args.split is not None:
        img = scene.render_split(
            splats, eye=eye, center=center, width=args.width,
            height=args.height, fov_deg=args.fov, mode=mode, light=light,
            split_x=args.split,
        )
    else:
        img = scene.render(
            splats, eye=eye, center=center, width=args.width,
            height=args.height, fov_deg=args.fov, mode=mode,
            shadows=args.shadows, light=light,
            model_transform=model_transform, gaussian_std=args.std,
        )
    img = torch.clamp(img, 0, 1).cpu().numpy()
    Image.fromarray((img * 255).astype(np.uint8)).save(args.output)
    print(f"{args.input} -> {args.output} [{args.mode}] "
          f"{img.shape[1]}x{img.shape[0]}")


def cmd_batch(args):
    """Folder queue like the reference's batch state machine; a failing item
    is reported and the queue goes on (markBatchItemDone/Failed,
    guiRendererConcreteMediator.cpp:170-179)."""
    in_dir = pathlib.Path(args.input_dir)
    out_dir = pathlib.Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    items = sorted(in_dir.glob("*.glb"))
    if not items:
        print(f"no .glb files in {in_dir}")
        return
    ok = failed = 0
    for item in items:
        out = out_dir / (item.stem + ".ply")
        try:
            a = argparse.Namespace(**vars(args), input=str(item), output=str(out))
            cmd_convert(a)
            ok += 1
        except Exception as e:  # noqa: BLE001 — per-item isolation
            print(f"FAILED {item.name}: {e}", file=sys.stderr)
            failed += 1
    print(f"batch done: {ok} converted, {failed} failed")


def main(argv=None):
    args = _build_parser().parse_args(argv)
    {"convert": cmd_convert, "render": cmd_render, "batch": cmd_batch}[args.cmd](args)


if __name__ == "__main__":
    main()
