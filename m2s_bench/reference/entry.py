"""The reference's counterparts of the entries the benchmark drives: a
conversion as ``Scene.convert`` makes it (one primitive, calibrated) and a
frame as ``Scene.render`` makes it, from the benchmark's raw asset tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.conversion import ConversionConfig, calibrate, convert as _convert
from .render.pipeline import FrameConfig, calibrate_frame, render_frame
from .types import Material, RenderMode, SplatFormat, TriangleMesh, make_camera


def mesh_material(asset: dict):
    """The asset as the reference's (TriangleMesh, Material), on the
    asset's device (as the port's GLB loader lays a primitive out)."""
    mesh = TriangleMesh(tri_pos=asset["tri_pos"],
                        tri_normal=asset["tri_normal"],
                        tri_tangent=asset["tri_tangent"],
                        tri_uv=asset["tri_uv"])
    mat = Material(
        base_color_factor=asset["base_color_factor"],
        metallic_factor=float(np.float32(asset["metallic_factor"])),
        roughness_factor=float(np.float32(asset["roughness_factor"])),
        base_color=asset["base_color_tex"],
        normal=asset["normal_tex"],
        metallic_roughness=asset["metallic_roughness_tex"],
        has_base_color=True, has_normal=True, has_metallic_roughness=True)
    return mesh, mat


@torch.no_grad()
def convert(asset: dict, resolution: int, layers: int, gaussian_std: float,
            calibrated: bool = True):
    """The asset's splats and the conversion config, as a calibrated
    ``Scene.convert`` of one primitive computes them."""
    mesh, mat = mesh_material(asset)
    flat = asset["tri_pos"].reshape(-1, 3)
    lo, hi = flat.amin(0), flat.amax(0)
    cfg = ConversionConfig(resolution=resolution, layers=layers,
                           gaussian_std=gaussian_std)
    pcfg = calibrate(mesh, lo, hi, cfg) if calibrated else cfg
    return _convert(mesh, mat, lo, hi, pcfg), cfg


@torch.no_grad()
def render(splats, cfg: ConversionConfig, eye, width: int, height: int,
           fov_deg: float, mode: str, shadows: bool):
    """An (H, W, 3) frame as ``Scene.render`` computes it, the camera
    looking at the origin with +y up and the default light."""
    cam = make_camera(eye=list(eye), center=[0.0, 0.0, 0.0],
                      up=[0.0, 1.0, 0.0], fov_y_rad=np.deg2rad(fov_deg),
                      width=width, height=height, device=splats.pos.device)
    fc = FrameConfig(width=width, height=height,
                     render_mode=RenderMode[mode],
                     splat_format=SplatFormat.MESH2SPLAT,
                     gaussian_std=cfg.gaussian_std,
                     resolution_target=cfg.resolution, shadows=shadows,
                     has_pbr=True)
    fc = calibrate_frame(splats, cam, fc)
    return render_frame(splats, cam, fc)
