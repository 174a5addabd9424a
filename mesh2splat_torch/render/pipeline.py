"""Frame pipeline (counterpart of ``mesh2splat_tpu.render.pipeline``):
projection -> binning -> composite -> deferred resolve, configured by an
immutable FrameConfig, with the shadow cubemap (FINAL mode with
``shadows``), the mesh depth prepass (``depth_test_mesh``) and the
split-screen mesh-vs-splat compare. ``use_tiled=False`` takes the dense
rasterizer.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.projection import project_splats
from ..types import Camera, Material, RenderMode, SplatFormat, Splats, TriangleMesh
from ..utils.profiling import annotate
from .binning import required_overflow, round_pow2_budget
from .lighting import PointLight, deferred_resolve
from .mesh_raster import rasterize_mesh
from .rasterize import rasterize_dense
from .shadows import pcf_shadow_factor, render_shadow_cubemap
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
    shadow_size: int = 1024  # cubemap face size
    has_pbr: bool = True
    pair_capacity: int = 0   # class-C pair budget (0 = calibrate per frame)

    @property
    def std_dev(self) -> float:
        """std_dev = gaussianStd / resolutionTarget."""
        return self.gaussian_std / self.resolution_target


def _project(splats, camera, config, model_to_world, depth_map=None):
    return project_splats(
        splats, camera, std_dev=config.std_dev,
        render_mode=config.render_mode, splat_format=config.splat_format,
        has_pbr=config.has_pbr, model_to_world=model_to_world,
        depth_map=depth_map,
    )


def render_gbuffer(splats: Splats, camera: Camera, config: FrameConfig,
                   depth_map=None, model_to_world=None):
    """Prepass + bin + composite -> splat G-buffer dict. depth_map: the
    mesh depth prepass (project_splats)."""
    proj = _project(splats, camera, config, model_to_world, depth_map)
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


def _frame_core(splats, camera, light, mesh, material, cubemap,
                config: FrameConfig, model_to_world=None):
    """Everything after the shadow cubemap: the mesh depth prepass, the
    splat G-buffer, the shadow factor and the resolve."""
    depth_map = None
    if mesh is not None and config.depth_test_mesh:
        if model_to_world is not None:
            # occlusion is tested against the moved mesh
            M = model_to_world.to(mesh.tri_pos)
            mesh = dataclasses.replace(
                mesh, tri_pos=mesh.tri_pos @ M[:3, :3].T + M[:3, 3])
        _, depth_ndc = rasterize_mesh(
            mesh, material or Material.default(splats.device), camera,
            config.width, config.height, opaque_only=True,
            device=splats.device)
        # projection reads rows from the bottom (v up); the map's row 0 is
        # the top
        depth_map = torch.flip(depth_ndc, [0])

    gbuffer = render_gbuffer(splats, camera, config, depth_map=depth_map,
                             model_to_world=model_to_world)
    with annotate("m2s.render.resolve"):
        shadow = None
        if cubemap is not None:
            shadow = pcf_shadow_factor(cubemap, gbuffer["position"][..., :3])
        return deferred_resolve(gbuffer, camera_position(camera), light,
                                render_mode=config.render_mode,
                                shadow_factor=shadow)


def calibrate_frame(splats: Splats, camera: Camera, config: FrameConfig,
                    model_to_world=None) -> FrameConfig:
    """Size the class-C pair budget to this scene and view (pow2-rounded);
    same image as any larger budget."""
    with annotate("m2s.render.calibrate"):
        proj = _project(splats, camera, config, model_to_world)
        p = int(required_overflow(proj, config.width, config.height))
        return dataclasses.replace(config, pair_capacity=round_pow2_budget(p))


def render_frame(splats: Splats, camera: Camera, config: FrameConfig,
                 light: PointLight | None = None,
                 mesh: TriangleMesh | None = None,
                 material: Material | None = None,
                 model_to_world=None) -> torch.Tensor:
    """Full frame to an (H, W, 3) image on the splats' device. With a
    ``mesh`` and ``config.depth_test_mesh``, opaque splats behind the mesh
    are culled; FINAL with ``config.shadows`` renders the light's shadow
    cubemap first (far 25). model_to_world: an optional (4, 4) model
    matrix applied to the splats (and the mesh)."""
    light = light or PointLight.default(splats.device)
    if config.use_tiled and config.pair_capacity == 0:
        config = calibrate_frame(splats, camera, config,
                                 model_to_world=model_to_world)
    cubemap = None
    if config.shadows and int(config.render_mode) == int(RenderMode.FINAL):
        cubemap = render_shadow_cubemap(
            splats, light.position, far=25.0, std_dev=config.std_dev,
            size=config.shadow_size, model_to_world=model_to_world,
            splat_format=config.splat_format, device=splats.device)
    return _frame_core(splats, camera, light,
                       mesh if config.depth_test_mesh else None, material,
                       cubemap, config, model_to_world=model_to_world)


def render_split_screen(splats: Splats, mesh: TriangleMesh,
                        material: Material, camera: Camera,
                        config: FrameConfig,
                        light: PointLight | None = None,
                        split_x: float = 0.5) -> torch.Tensor:
    """Split-screen mesh-vs-splat compare: left of ``split_x`` (a share of
    the width) the rasterized mesh's G-buffer, right of it the splats',
    both resolved with the same light, and a white divider 2 px wide."""
    dev = splats.device
    light = light or PointLight.default(dev)
    cam_pos = camera_position(camera)
    mesh_gbuf, _ = rasterize_mesh(mesh, material, camera, config.width,
                                  config.height,
                                  render_mode=config.render_mode, device=dev)
    splat_gbuf = render_gbuffer(splats, camera, config)
    img_mesh = deferred_resolve(mesh_gbuf, cam_pos, light, config.render_mode)
    img_splat = deferred_resolve(splat_gbuf, cam_pos, light,
                                 config.render_mode)
    xs = torch.arange(config.width, dtype=torch.float32,
                      device=dev) / config.width
    img = torch.where((xs < split_x)[None, :, None], img_mesh, img_splat)
    divider = (xs - split_x).abs() * config.width < 1.0
    return torch.where(divider[None, :, None],
                       torch.ones(3, device=dev), img)


def image_diff_metrics(img_a, img_b) -> dict:
    """The split screen as numbers: mean absolute error and PSNR over RGB
    (0-d tensors)."""
    diff = (img_a - img_b).abs()
    mse = (diff * diff).mean()
    return {"mae": diff.mean(),
            "psnr": -10.0 * torch.log10(torch.clamp(mse, min=1e-12))}
