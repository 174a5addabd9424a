"""The reference's counterpart of the texture fitter (``train.fit``'s
``texture_step_fn``): one Adam step of an asset's base-colour map through
the conversion, in plain PyTorch over the frozen copies, float32 with TF32
off.

A step converts the mesh with the map (the frozen conversion: slot
allocation, the tap atlas with its mips, the plain K1 and
``fragment_apply_plain``), renders each view in SplatFormat.MESH2SPLAT
ALBEDO (the frozen projection and binning, and ``train.py``'s
``_AlbedoComposite`` over ``tile_batch`` tiles at a time), takes the mean
L2 over the views, differentiates it with respect to the map, steps
``train.py``'s ``Adam`` and clamps the map to [0, 1].

The conversion's fragment shader is differentiated by autograd through
``fragment_apply_plain`` itself: the frozen ``_FragmentApply`` (the custom
VJP, a copy of the program's) is not called, so the program's VJP is held
to plain autograd of the same mathematics.

Departures from the program's order of operations, each of rounding only:
- the gradient comes from ``torch.autograd.grad``, not from
  ``loss.backward()`` into ``tex.grad``;
- the fragment shader's gradient is autograd's through the forward's own
  graph, where the program's VJP gathers the taps again and recomputes
  ``_fragment_math``; the forward is the plain version, where the card
  runs K1 and K2;
- the composite's forward and backward are the plain versions over
  batches of tiles, where the card runs K3 and K4;
- ``Adam`` updates with ``mul_`` and ``add_`` where ``torch.optim.Adam``
  uses ``lerp_``.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from .ops import conversion as RC
from .ops import fragment as RF
from .ops.projection import project_splats
from .render import binning as B
from .render import composite as C
from .train import Adam, _AlbedoComposite
from .types import RenderMode, SplatFormat


def _fragment_apply_autograd(records, tapsT, metaT, res, geom, k, has_base,
                             has_normal, has_mr, taps_packed=False,
                             local_in_kernel=False, rows=None):
    """``fragment.fragment_apply``'s signature and results, computed by
    ``fragment_apply_plain`` (found on its module at each call, where the
    roofline modules wrap it) under autograd."""
    out = RF.fragment_apply_plain(
        records, tapsT, metaT, res=res, geom=geom, k=k, has_base=has_base,
        has_normal=has_normal, has_mr=has_mr, taps_packed=taps_packed,
        local_in_kernel=local_in_kernel, rows=rows)
    return out, metaT[2:3]


@contextlib.contextmanager
def _plain_autograd():
    """The frozen conversion with its K2 call taken by
    ``_fragment_apply_autograd``."""
    orig = RF.fragment_apply
    RF.fragment_apply = _fragment_apply_autograd
    try:
        yield
    finally:
        RF.fragment_apply = orig


@contextlib.contextmanager
def _no_tf32():
    keep = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = keep


def calibrated_config(mesh, lo, hi, resolution: int, layers: int,
                      gaussian_std: float):
    """The conversion config, calibrated to the mesh as the program's set-up
    calibrates it."""
    return RC.calibrate(mesh, lo, hi, RC.ConversionConfig(
        resolution=resolution, layers=layers, gaussian_std=gaussian_std))


def convert(mesh, material, lo, hi, cfg):
    """The splats of ``mesh`` with ``material``, differentiable with respect
    to its maps through plain autograd."""
    with _plain_autograd():
        return RC.convert(mesh, material, lo, hi, cfg)


def _project(splats, camera, std_dev):
    return project_splats(splats, camera, std_dev=std_dev,
                          render_mode=RenderMode.ALBEDO,
                          splat_format=SplatFormat.MESH2SPLAT)


def render_rgb(splats, camera, width: int, height: int, std_dev: float,
               pair_capacity: int, tile_batch: int):
    """Differentiable (H, W, 3) render in SplatFormat.MESH2SPLAT:
    premultiplied albedo over black."""
    proj = _project(splats, camera, std_dev)
    ty, tx = B.tiles_for(width, height)
    binned = B.bin_pairs(proj, width, height, pair_capacity,
                         variant="albedo")
    C._check_inputs(binned.fields, binned.tile_starts, ty, tx, "albedo")
    out = _AlbedoComposite.apply(binned.fields, binned.tile_starts, height,
                                 ty, tx, tile_batch)
    return torch.stack([out[0], out[1], out[2]], dim=-1)[:height, :width]


@torch.no_grad()
def pair_need(splats, cameras, width: int, height: int,
              std_dev: float) -> int:
    """The worst view's class-C pair need, projected as the loss renders."""
    return max(int(B.required_overflow(_project(splats, cam, std_dev),
                                       width, height)) for cam in cameras)


def mean_l2(splats, cameras, targets, width, height, std_dev, pair_capacity,
            tile_batch):
    """Mean over the views of each view's mean squared error: ``targets``
    (V, H, W, 3)."""
    return torch.stack([
        torch.mean((render_rgb(splats, cam, width, height, std_dev,
                               pair_capacity, tile_batch) - t) ** 2)
        for cam, t in zip(cameras, targets)]).mean()


def first_steps(mesh, material, lo, hi, cfg, start, cameras, targets, width,
                height, pair_capacity, lr, steps, tile_batch,
                unit=lambda k: contextlib.nullcontext()) -> dict:
    """``steps`` Adam steps of the mean L2 from the base-colour map
    ``start`` (not changed). Returns each step's loss, the first step's
    gradient of the map and the map's change over the steps. ``unit(k)``
    wraps step k (the roofline modules' key)."""
    std_dev = cfg.scale_multiplier
    tex = start.detach().clone().requires_grad_(True)
    mat = dataclasses.replace(material, base_color=tex, has_base_color=True)
    adam = Adam([tex], lr)
    losses, grad = [], None
    with _no_tf32():
        for k in range(steps):
            with unit(k):
                splats = convert(mesh, mat, lo, hi, cfg)
                loss = mean_l2(splats, cameras, targets, width, height,
                               std_dev, pair_capacity, tile_batch)
                (g,) = torch.autograd.grad(loss, [tex])
                losses.append(float(loss.detach()))
                del loss, splats
            if k == 0:
                grad = g.detach().clone()
            adam.step([g])
            del g
            with torch.no_grad():
                tex.clamp_(0.0, 1.0)
    return {"losses": losses, "grad": grad,
            "change": tex.detach() - start.detach()}


@torch.no_grad()
def targets(mesh, material, lo, hi, cfg, cameras, width, height, tile_batch):
    """The views of the splats converted from ``material``'s own maps, with
    no class-C pair dropped; and the class-C pair budget that covers them
    (the need rounded up to a power of two)."""
    with _no_tf32():
        splats = convert(mesh, material, lo, hi, cfg)
        std_dev = cfg.scale_multiplier
        budget = B.round_pow2_budget(pair_need(splats, cameras, width, height,
                                               std_dev))
        views = torch.stack([
            render_rgb(splats, cam, width, height, std_dev, budget,
                       tile_batch) for cam in cameras])
    return views, budget

