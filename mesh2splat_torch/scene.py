"""Scene: the user-facing API of the port (counterpart of
``mesh2splat_tpu.scene``): load a GLB or PLY, convert, render, export.

    scene = Scene.from_glb("helmet.glb")          # tensors on cuda
    splats = scene.convert(resolution=512)
    img = scene.render(splats, eye=[0, 0, 3])
    split = scene.render_split(splats, eye=[0, 0, 3])   # mesh | splats
    scene.export_ply(splats, "helmet.ply", fmt=1)

``Scene.from_glb(path, device="cpu")`` runs the same code on the CPU; every
later step follows the device of the loaded tensors.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from .io import gltf, ply
from .ops.conversion import (
    ConversionConfig, calibrate, convert, convert_packed,
)
from .render.pipeline import (
    FrameConfig, calibrate_frame, render_frame, render_split_screen,
)
from .types import (
    RenderMode, SplatFormat, Splats, TriangleMesh, compose_trs, make_camera,
    resolve_device,
)
from .utils.profiling import annotate


@dataclasses.dataclass
class Scene:
    """A loaded asset: list of primitives + bookkeeping."""

    primitives: list          # [(TriangleMesh, Material, GltfPrimitive)]
    splat_format: SplatFormat = SplatFormat.MESH2SPLAT
    has_pbr: bool = True
    last_config: ConversionConfig | None = None
    imported_splats: Splats | None = None

    @staticmethod
    def from_glb(path, device="cuda") -> "Scene":
        dev = resolve_device(device)
        prims = gltf.load_glb(path)
        if not prims:
            raise ValueError(f"no triangle primitives in {path}")
        return Scene(primitives=[(*gltf.to_device(pr, dev), pr)
                                 for pr in prims])

    @staticmethod
    def from_ply(path, device="cuda") -> "Scene":
        """Import a splat PLY; ``has_pbr`` says whether it carries normals
        and metallic-roughness."""
        arrs, has_pbr = ply.read_ply(path)
        sc = Scene(primitives=[], splat_format=SplatFormat.PLY_3DGS,
                   has_pbr=has_pbr)
        sc.imported_splats = ply.arrays_to_splats(arrs, device=device)
        return sc

    def convert(self, resolution: int = 512, layers: int = 6,
                gaussian_std: float = 1.0, calibrated: bool = True,
                return_stats: bool = False) -> Splats:
        """Convert every primitive (one fused pass when there are several).
        ``calibrated`` sizes the slot budget to the mesh (identical
        splats, lower cost). ``return_stats`` also returns the
        budget-overflow counters."""
        if not self.primitives:
            raise ValueError("Scene has no mesh primitives (PLY import?)")
        cfg = ConversionConfig(resolution=resolution, layers=layers,
                               gaussian_std=gaussian_std)
        self.last_config = cfg
        with annotate("m2s.convert"):
            if len(self.primitives) > 1:
                return convert_packed(
                    [(mesh, mat) for mesh, mat, _ in self.primitives], cfg,
                    calibrate_budget=calibrated, return_stats=return_stats,
                )
            mesh, mat, pr = self.primitives[0]
            with annotate("m2s.convert.bbox"):
                lo, hi = (mesh.tri_pos.new_tensor(b) for b in pr.bbox())
            pcfg = calibrate(mesh, lo, hi, cfg) if calibrated else cfg
            return convert(mesh, mat, lo, hi, pcfg, return_stats=return_stats)

    def render(self, splats: Splats, eye, center=(0, 0, 0), up=(0, 1, 0),
               width=1280, height=720, fov_deg=60.0,
               mode: RenderMode = RenderMode.ALBEDO, shadows=False,
               light=None, model_transform=None, gaussian_std=None):
        """An (H, W, 3) image on the splats' device. model_transform: a
        (4, 4) matrix or a (translation, rotation_wxyz, scale) tuple.
        gaussian_std overrides the conversion's sigma (imported 3DGS PLYs
        store real-unit scales, so it does not apply to them)."""
        with annotate("m2s.render"):
            dev = splats.device
            if (model_transform is not None
                    and isinstance(model_transform, tuple)):
                model_transform = compose_trs(*model_transform, device=dev)
            cam = make_camera(eye=list(eye), center=list(center),
                              up=list(up), fov_y_rad=np.deg2rad(fov_deg),
                              width=width, height=height, device=dev)
            res_target = (self.last_config.resolution if self.last_config
                          else 1)
            std = gaussian_std if gaussian_std is not None else (
                self.last_config.gaussian_std if self.last_config else 1.0)
            fc = FrameConfig(
                width=width, height=height, render_mode=mode,
                splat_format=self.splat_format, gaussian_std=std,
                resolution_target=res_target, shadows=shadows,
                has_pbr=self.has_pbr,
            )
            fc = calibrate_frame(splats, cam, fc,
                                 model_to_world=model_transform)
            return render_frame(splats, cam, fc, light=light,
                                model_to_world=model_transform)

    def render_split(self, splats: Splats, eye, center=(0, 0, 0),
                     up=(0, 1, 0), width=1280, height=720, fov_deg=60.0,
                     mode: RenderMode = RenderMode.ALBEDO, light=None,
                     split_x: float = 0.5):
        """Split-screen mesh-vs-splat compare on the splats' device: left of
        ``split_x`` the rasterized source mesh, right of it the splats.
        Several primitives are compared as one merged triangle soup with
        the first primitive's material."""
        if not self.primitives:
            raise ValueError("split-screen compare needs mesh primitives")
        dev = splats.device
        meshes = [m for m, _, _ in self.primitives]
        mesh = TriangleMesh(**{
            f.name: torch.cat([getattr(m, f.name).to(dev) for m in meshes])
            for f in dataclasses.fields(TriangleMesh)})
        material = self.primitives[0][1]
        cam = make_camera(eye=list(eye), center=list(center), up=list(up),
                          fov_y_rad=np.deg2rad(fov_deg), width=width,
                          height=height, device=dev)
        res_target = self.last_config.resolution if self.last_config else 1
        std = self.last_config.gaussian_std if self.last_config else 1.0
        fc = FrameConfig(
            width=width, height=height, render_mode=mode,
            splat_format=self.splat_format, gaussian_std=std,
            resolution_target=res_target, has_pbr=self.has_pbr,
        )
        fc = calibrate_frame(splats, cam, fc)
        return render_split_screen(splats, mesh, material, cam, fc,
                                   light=light, split_x=split_x)

    def export_ply(self, splats: Splats, path, fmt: int = 0,
                   background: bool = False):
        """Export with the conversion-derived scale multiplier.
        ``background=True`` writes on a daemon thread and returns it (the
        device -> host copy happens before the thread starts)."""
        mult = (self.last_config.scale_multiplier
                if self.last_config is not None else 1.0)
        arrs = ply.splats_to_arrays(splats)
        if background:
            t = threading.Thread(target=ply.write_ply,
                                 args=(path, arrs, fmt, mult), daemon=True)
            t.start()
            return t
        ply.write_ply(path, arrs, fmt=fmt, scale_multiplier=mult)
        return None
