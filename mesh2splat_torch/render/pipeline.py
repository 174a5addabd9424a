"""Frame pipeline (counterpart of ``mesh2splat_tpu.render.pipeline``):
projection -> binning -> composite -> deferred resolve, configured by an
immutable FrameConfig.

Options of the JAX package that need modules this port does not have yet
raise NotImplementedError naming their slice: shadows in FINAL mode (kernel
K5) and the mesh depth prepass (mesh raster). ``use_tiled=False`` takes the
dense rasterizer.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.projection import project_splats
from ..types import Camera, Material, RenderMode, SplatFormat, Splats, TriangleMesh
from .binning import required_overflow, round_pow2_budget
from .lighting import PointLight, deferred_resolve
from .rasterize import rasterize_dense
from .tiled import rasterize_tiled


@dataclasses.dataclass(frozen=True)
class FrameConfig:
    """Per-frame settings (the UI-controlled knobs of the reference)."""

    width: int = 1280
    height: int = 720
    render_mode: RenderMode = RenderMode.ALBEDO
    splat_format: SplatFormat = SplatFormat.MESH2SPLAT
    gaussian_std: float = 1.0
    resolution_target: int = 256
    use_tiled: bool = True
    depth_test_mesh: bool = False
    shadows: bool = False
    has_pbr: bool = True
    pair_capacity: int = 0   # class-C pair budget (0 = calibrate per frame)

    @property
    def std_dev(self) -> float:
        """std_dev = gaussianStd / resolutionTarget."""
        return self.gaussian_std / self.resolution_target


def _check_supported(config: FrameConfig):
    if config.depth_test_mesh:
        raise NotImplementedError(
            "depth_test_mesh needs the mesh rasterizer, which the port "
            "brings in its mesh-raster slice"
        )
    if config.shadows and int(config.render_mode) == int(RenderMode.FINAL):
        raise NotImplementedError(
            "shadows need the min-depth kernel (K5) and the shadow cubemap, "
            "which the port brings in its shadows slice"
        )


def _project(splats, camera, config, model_to_world):
    return project_splats(
        splats, camera, std_dev=config.std_dev,
        render_mode=config.render_mode, splat_format=config.splat_format,
        has_pbr=config.has_pbr, model_to_world=model_to_world,
    )


def render_gbuffer(splats: Splats, camera: Camera, config: FrameConfig,
                   model_to_world=None):
    """Prepass + bin + composite -> splat G-buffer dict."""
    _check_supported(config)
    proj = _project(splats, camera, config, model_to_world)
    if not config.use_tiled:
        return rasterize_dense(proj, config.width, config.height,
                               render_mode=config.render_mode,
                               device=splats.device)
    return rasterize_tiled(proj, config.width, config.height,
                           render_mode=config.render_mode,
                           pair_capacity=config.pair_capacity)


def camera_position(camera: Camera) -> torch.Tensor:
    W = camera.world_to_view
    return -(W[:3, :3].T @ W[:3, 3])


def _frame_core(splats, camera, light, config: FrameConfig,
                model_to_world=None):
    gbuffer = render_gbuffer(splats, camera, config,
                             model_to_world=model_to_world)
    return deferred_resolve(gbuffer, camera_position(camera), light,
                            render_mode=config.render_mode)


def calibrate_frame(splats: Splats, camera: Camera, config: FrameConfig,
                    model_to_world=None) -> FrameConfig:
    """Size the class-C pair budget to this scene and view (pow2-rounded);
    same image as any larger budget."""
    proj = _project(splats, camera, config, model_to_world)
    p = int(required_overflow(proj, config.width, config.height))
    return dataclasses.replace(config, pair_capacity=round_pow2_budget(p))


def render_frame(splats: Splats, camera: Camera, config: FrameConfig,
                 light: PointLight | None = None,
                 mesh: TriangleMesh | None = None,
                 material: Material | None = None,
                 model_to_world=None) -> torch.Tensor:
    """Full frame to an (H, W, 3) image on the splats' device."""
    _check_supported(config)
    light = light or PointLight.default(splats.device)
    if config.use_tiled and config.pair_capacity == 0:
        config = calibrate_frame(splats, camera, config,
                                 model_to_world=model_to_world)
    return _frame_core(splats, camera, light, config,
                       model_to_world=model_to_world)
