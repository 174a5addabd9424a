"""Differentiable splat refinement (counterpart of
``mesh2splat_tpu.train.fit``): Adam on the splat parameters, or on the
source texture through conversion, against target images.

Parameterization follows 3DGS storage: opacity through a sigmoid (logit
params), scale through exp (log params), quaternions normalised on use.
``optax.adam`` becomes ``torch.optim.Adam`` with the same lr, b1 = 0.9,
b2 = 0.999 and eps = 1e-8 (the same update). A batch of views is a list of
cameras and a (V, H, W, 3) target tensor; ``vmap`` over views becomes a
loop. The entry points run on ``device`` ("cuda" unless the caller asks
for "cpu"), moving their inputs there.

Data-parallel training (``fit_splats(devices_mesh=)``, ``train_step_fn(
mesh=)``) runs one process a device over a ``DeviceMesh`` with a ``dp``
axis (``parallel.sharding``): each rank renders its block of the views, and
the loss and the gradients are averaged over the ranks before Adam, the
JAX step's ``pmean`` over ``dp``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.projection import project_splats
from ..parallel.sharding import max_over, mean_over, shard_batch
from ..render.binning import required_overflow, round_pow2_budget
from ..render.rasterize import rasterize_dense
from ..render.tiled import rasterize_tiled
from ..types import (
    Camera, RenderMode, SplatFormat, Splats, inv_sigmoid, resolve_device,
    sigmoid, to_device,
)

ADAM_BETAS = (0.9, 0.999)   # optax.adam's defaults
ADAM_EPS = 1e-8


@dataclasses.dataclass
class SplatParams:
    """Unconstrained optimization view of Splats (leaf tensors)."""

    pos: torch.Tensor            # (N, 3)
    color: torch.Tensor          # (N, 3) rgb
    opacity_logit: torch.Tensor  # (N,)
    log_scale: torch.Tensor      # (N, 3)
    quat: torch.Tensor           # (N, 4) unnormalized wxyz
    normal: torch.Tensor         # (N, 3)
    pbr: torch.Tensor            # (N, 2)

    @staticmethod
    def from_splats(s: Splats) -> "SplatParams":
        p = SplatParams(
            pos=s.pos,
            color=s.color[:, :3],
            opacity_logit=inv_sigmoid(torch.clamp(s.color[:, 3], 1e-4,
                                                  1.0 - 1e-4)),
            log_scale=torch.log(torch.clamp(s.scale, min=1e-12)),
            quat=s.quat,
            normal=s.normal,
            pbr=s.pbr,
        )
        return SplatParams(**{k: v.detach().clone().requires_grad_(True)
                              for k, v in p.as_dict().items()})

    def as_dict(self) -> dict:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}

    def parameters(self) -> list:
        return list(self.as_dict().values())

    def to_splats(self, valid) -> Splats:
        q = self.quat / (torch.linalg.vector_norm(self.quat, dim=-1,
                                                  keepdim=True) + 1e-12)
        return Splats(
            pos=self.pos,
            color=torch.cat([self.color, sigmoid(self.opacity_logit)[:, None]],
                            dim=-1),
            scale=torch.exp(self.log_scale),
            normal=self.normal,
            quat=q,
            pbr=self.pbr,
            valid=valid,
        )


def render_rgb(splats: Splats, camera: Camera, width: int, height: int,
               std_dev: float = 1.0,
               splat_format: SplatFormat = SplatFormat.PLY_3DGS,
               use_tiled: bool = True, pair_capacity: int = 0):
    """Differentiable (H, W, 3) render: premultiplied albedo over black."""
    proj = project_splats(splats, camera, std_dev=std_dev,
                          render_mode=RenderMode.ALBEDO,
                          splat_format=splat_format)
    if use_tiled:
        out = rasterize_tiled(proj, width, height, albedo_only=True,
                              pair_capacity=pair_capacity)
    else:
        out = rasterize_dense(proj, width, height, device=proj.depth.device)
    return out["albedo"][..., :3]


def mean_l2(splats: Splats, cameras, targets, width, height, std_dev=1.0,
            splat_format: SplatFormat = SplatFormat.PLY_3DGS,
            use_tiled=True, pair_capacity=0):
    """Mean over a batch of views of each view's mean squared error between
    ``render_rgb`` of ``splats`` and its target: ``cameras`` a sequence of
    cameras, ``targets`` (V, H, W, 3)."""
    losses = [
        torch.mean((render_rgb(splats, cam, width, height, std_dev,
                               splat_format=splat_format,
                               use_tiled=use_tiled,
                               pair_capacity=pair_capacity) - target) ** 2)
        for cam, target in zip(cameras, targets)
    ]
    return torch.stack(losses).mean()


def l2_loss(params: SplatParams, valid, cameras, targets, width, height,
            std_dev=1.0, use_tiled=True, pair_capacity=0):
    """Mean L2 over a batch of views of the splats ``params`` holds, rendered
    in SplatFormat.PLY_3DGS."""
    return mean_l2(params.to_splats(valid), cameras, targets, width, height,
                   std_dev, use_tiled=use_tiled, pair_capacity=pair_capacity)


@dataclasses.dataclass
class FitConfig:
    steps: int = 100
    lr: float = 1e-2
    width: int = 128
    height: int = 128
    std_dev: float = 1.0
    use_tiled: bool = True


def _adam(tensors, lr):
    return torch.optim.Adam(tensors, lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS)


def train_step_fn(optimizer, width, height, std_dev=1.0, use_tiled=True,
                  mesh=None, pair_capacity=0):
    """A (params, valid, cameras, targets) -> loss step that updates the
    optimizer's parameters in place (the JAX step returns new params and
    optimizer state instead). With ``mesh`` (a DeviceMesh with a ``dp``
    axis) every rank passes all the views: it renders its block of them,
    and the loss it returns and the gradients Adam takes are the means
    over the ranks."""

    def step(params, valid, cameras, targets):
        optimizer.zero_grad(set_to_none=True)
        if mesh is not None:
            cameras = shard_batch(list(cameras), mesh)
            targets = shard_batch(targets, mesh)
        loss = l2_loss(params, valid, cameras, targets, width, height,
                       std_dev=std_dev, use_tiled=use_tiled,
                       pair_capacity=pair_capacity)
        loss.backward()
        loss = loss.detach()
        if mesh is not None:
            mean_over(loss, mesh)
            for p in params.parameters():
                if p.grad is not None:
                    mean_over(p.grad, mesh)
        optimizer.step()
        return loss

    return step


@torch.no_grad()
def pair_budget(splats: Splats, cameras, width, height, mesh=None,
                splat_format: SplatFormat = SplatFormat.PLY_3DGS,
                std_dev: float = 1.0) -> int:
    """The class-C pair budget of renders of ``splats``: the worst view's
    need, projected in ``splat_format`` with ``std_dev`` (the defaults are
    ``l2_loss``'s: PLY_3DGS, where std_dev has no effect), rounded up to a
    power of two; one host read. With ``mesh`` the worst over every rank's
    ``cameras`` (all_reduce MAX)."""
    need = torch.stack([
        required_overflow(project_splats(splats, cam, std_dev=std_dev,
                                         render_mode=RenderMode.ALBEDO,
                                         splat_format=splat_format),
                          width, height)
        for cam in cameras]).max()
    if mesh is not None:
        max_over(need, mesh)
    return round_pow2_budget(int(need))


def fit_splats(splats: Splats, cameras, targets, config: FitConfig,
               devices_mesh=None, device="cuda"):
    """Adam refinement of splat params against (V, H, W, 3) targets, one
    camera per view. Returns (fitted Splats, per-step loss history).
    ``devices_mesh``: a DeviceMesh with a ``dp`` axis on ``device``'s type;
    every rank passes the same inputs, the views are split over the ranks
    (their number must divide evenly) and every rank gets the same
    result."""
    dev = resolve_device(device)
    if devices_mesh is not None and devices_mesh.device_type != dev.type:
        raise ValueError(f"devices_mesh is on {devices_mesh.device_type}, "
                         f"the fit on {dev.type}")
    splats = to_device(splats, dev)
    cameras = [to_device(c, dev) for c in cameras]
    targets = torch.as_tensor(targets, dtype=torch.float32, device=dev)
    params = SplatParams.from_splats(splats)
    valid = splats.valid
    opt = _adam(params.parameters(), config.lr)

    pair_cap = 0
    if config.use_tiled:
        views = (cameras if devices_mesh is None
                 else shard_batch(cameras, devices_mesh))
        pair_cap = pair_budget(splats, views, config.width, config.height,
                               mesh=devices_mesh)
    step = train_step_fn(opt, config.width, config.height,
                         std_dev=config.std_dev, use_tiled=config.use_tiled,
                         mesh=devices_mesh, pair_capacity=pair_cap)
    history = []
    for _ in range(config.steps):
        history.append(float(step(params, valid, cameras, targets)))
    fitted = params.to_splats(valid)
    return Splats(**{f.name: getattr(fitted, f.name).detach()
                     for f in dataclasses.fields(fitted)}), history


# ---------------------------------------------------------------------------
# end-to-end texture optimization: mesh -> convert -> project -> rasterize
# -> L2, differentiated back to the source base-colour texture
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FitTexturesConfig:
    steps: int = 60
    lr: float = 5e-2
    width: int = 64
    height: int = 64
    use_tiled: bool = True


def texture_step_fn(optimizer, tex, mesh, material, conv_config, bbox,
                    width, height, pair_capacity=0, use_tiled=True):
    """A (cameras, targets) -> loss step of ``fit_textures``, the counterpart
    of ``train_step_fn``: converts ``mesh`` with ``material`` whose
    base-colour map is ``tex`` (a leaf that ``optimizer`` holds), renders
    each view in SplatFormat.MESH2SPLAT with the conversion's sigma, takes
    the mean L2 over the views, carries its gradient back through the
    conversion into ``tex``, steps the optimizer and clamps ``tex`` to
    [0, 1] in place. ``bbox``: the mesh's (lo, hi), as ``convert`` takes
    it; ``pair_capacity``: the renders' class-C pair budget (0: the
    binner's default). Returns the detached loss."""
    from ..ops.conversion import convert

    lo, hi = bbox
    mat = dataclasses.replace(material, base_color=tex, has_base_color=True)

    def step(cameras, targets):
        optimizer.zero_grad(set_to_none=True)
        splats = convert(mesh, mat, lo, hi, conv_config)
        loss = mean_l2(splats, cameras, targets, width, height,
                       std_dev=conv_config.scale_multiplier,
                       splat_format=SplatFormat.MESH2SPLAT,
                       use_tiled=use_tiled, pair_capacity=pair_capacity)
        loss.backward()
        optimizer.step()
        with torch.no_grad():
            tex.clamp_(0.0, 1.0)
        return loss.detach()

    return step


def fit_textures(mesh_geom, material, conv_config, cameras, targets,
                 config: FitTexturesConfig, device="cuda"):
    """Optimize the source base-colour texture through conversion, step
    after step of ``texture_step_fn``; the texture is clipped to [0, 1]
    after each step. The splats' geometry does not depend on the texture,
    so the class-C pair budget of the tiled renders is set once, from a
    conversion of the start. Returns (material with the fitted texture,
    per-step loss history)."""
    from ..ops.conversion import convert

    dev = resolve_device(device)
    mesh_geom = to_device(mesh_geom, dev)
    material = to_device(material, dev)
    cameras = [to_device(c, dev) for c in cameras]
    targets = torch.as_tensor(targets, dtype=torch.float32, device=dev)
    lo, hi = mesh_geom.bbox()
    tex = material.base_color.detach().clone().requires_grad_(True)
    opt = _adam([tex], config.lr)

    pair_cap = 0
    if config.use_tiled:
        with torch.no_grad():
            splats = convert(mesh_geom, material, lo, hi, conv_config)
        pair_cap = pair_budget(splats, cameras, config.width, config.height,
                               splat_format=SplatFormat.MESH2SPLAT,
                               std_dev=conv_config.scale_multiplier)
        del splats
    step = texture_step_fn(opt, tex, mesh_geom, material, conv_config,
                           (lo, hi), config.width, config.height,
                           pair_capacity=pair_cap,
                           use_tiled=config.use_tiled)
    history = [float(step(cameras, targets)) for _ in range(config.steps)]
    fitted = dataclasses.replace(material, base_color=tex.detach(),
                                 has_base_color=True)
    return fitted, history
