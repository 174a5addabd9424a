"""The reference's counterpart of the trainer (``train.fit``): the splats'
unconstrained leaves (``SplatParams``), the differentiable ALBEDO render
(``render_rgb``), the mean L2 over a batch of views (``l2_loss``) and
Adam's update, in plain PyTorch over the frozen projection, binning and
composite. The composite's forward and backward are the frozen plain
versions, called through their module (so that the roofline modules'
wrappers see each call) with a batch of tiles as large as the run asks.
"""

from __future__ import annotations

import contextlib
import math

import torch

from .ops.projection import project_splats
from .render import binning as B
from .render import composite as C
from .types import RenderMode, SplatFormat, Splats, inv_sigmoid, sigmoid

LEAVES = ("pos", "color", "opacity_logit", "log_scale", "quat", "normal",
          "pbr")
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def leaves_from_splats(s: Splats) -> dict:
    """The unconstrained leaves of ``s``: opacity through a logit, scale
    through a log, as 3DGS stores them."""
    p = {
        "pos": s.pos,
        "color": s.color[:, :3],
        "opacity_logit": inv_sigmoid(torch.clamp(s.color[:, 3], 1e-4,
                                                 1.0 - 1e-4)),
        "log_scale": torch.log(torch.clamp(s.scale, min=1e-12)),
        "quat": s.quat,
        "normal": s.normal,
        "pbr": s.pbr,
    }
    return {k: p[k].detach().clone().requires_grad_(True) for k in LEAVES}


def to_splats(p: dict, valid) -> Splats:
    q = p["quat"] / (torch.linalg.vector_norm(p["quat"], dim=-1,
                                              keepdim=True) + 1e-12)
    return Splats(
        pos=p["pos"],
        color=torch.cat([p["color"], sigmoid(p["opacity_logit"])[:, None]],
                        dim=-1),
        scale=torch.exp(p["log_scale"]), normal=p["normal"], quat=q,
        pbr=p["pbr"], valid=valid)


class _AlbedoComposite(torch.autograd.Function):
    """The ALBEDO composite by its plain versions, ``tile_batch`` tiles at
    a time."""

    @staticmethod
    def forward(ctx, fields, tile_starts, height, ty, tx, tile_batch):
        out = C.composite_plain(fields, tile_starts, height, ty, tx, True,
                                tile_batch=tile_batch)
        ctx.save_for_backward(fields, tile_starts, out)
        ctx.meta = (height, ty, tx, tile_batch)
        return out

    @staticmethod
    def backward(ctx, ct):
        fields, tile_starts, out = ctx.saved_tensors
        height, ty, tx, tile_batch = ctx.meta
        dfields = C.composite_backward_plain(
            fields, tile_starts, out, ct.contiguous(), height, ty, tx, True,
            tile_batch=tile_batch)
        return dfields, None, None, None, None, None


def render_rgb(splats: Splats, camera, width: int, height: int,
               std_dev: float, pair_capacity: int, tile_batch: int):
    """Differentiable (H, W, 3) render in SplatFormat.PLY_3DGS:
    premultiplied albedo over black."""
    proj = project_splats(splats, camera, std_dev=std_dev,
                          render_mode=RenderMode.ALBEDO,
                          splat_format=SplatFormat.PLY_3DGS)
    ty, tx = B.tiles_for(width, height)
    binned = B.bin_pairs(proj, width, height, pair_capacity,
                         variant="albedo")
    C._check_inputs(binned.fields, binned.tile_starts, ty, tx, "albedo")
    out = _AlbedoComposite.apply(binned.fields, binned.tile_starts, height,
                                 ty, tx, tile_batch)
    return torch.stack([out[0], out[1], out[2]], dim=-1)[:height, :width]


@torch.no_grad()
def pair_need(splats: Splats, cameras, width: int, height: int) -> int:
    """The worst view's class-C pair need, projected as the loss renders."""
    return max(int(B.required_overflow(
        project_splats(splats, cam, render_mode=RenderMode.ALBEDO,
                       splat_format=SplatFormat.PLY_3DGS), width, height))
        for cam in cameras)


def l2_loss(p: dict, valid, cameras, targets, width, height, std_dev,
            pair_capacity, tile_batch):
    """Mean L2 over the views: ``targets`` (V, H, W, 3)."""
    splats = to_splats(p, valid)
    return torch.stack([
        torch.mean((render_rgb(splats, cam, width, height, std_dev,
                               pair_capacity, tile_batch) - t) ** 2)
        for cam, t in zip(cameras, targets)]).mean()


class Adam:
    """Adam's update (Kingma and Ba, with the bias corrections), one leaf
    at a time."""

    def __init__(self, leaves: list, lr: float):
        self.leaves, self.lr, self.t = leaves, lr, 0
        self.m = [torch.zeros_like(p) for p in leaves]
        self.v = [torch.zeros_like(p) for p in leaves]

    @torch.no_grad()
    def step(self, grads: list) -> None:
        b1, b2 = ADAM_BETAS
        self.t += 1
        bc1, bc2 = 1.0 - b1 ** self.t, 1.0 - b2 ** self.t
        for p, g, m, v in zip(self.leaves, grads, self.m, self.v):
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            denom = (v.sqrt() / math.sqrt(bc2)).add_(ADAM_EPS)
            p.addcdiv_(m, denom, value=-self.lr / bc1)


def norms(tensors) -> list:
    return [float(torch.linalg.vector_norm(t.double())) for t in tensors]


def first_steps(p: dict, valid, cameras, targets, width, height, std_dev,
                pair_capacity, lr, steps, tile_batch,
                unit=lambda k: contextlib.nullcontext()) -> dict:
    """``steps`` Adam steps of the mean L2 from the leaves ``p`` (updated in
    place). Returns each step's loss, the norm of each leaf's first
    gradient, and the norm of each leaf's change over the steps. ``unit(k)``
    wraps step k (the roofline modules' key)."""
    leaves = [p[k] for k in LEAVES]
    start = [x.detach().clone() for x in leaves]
    adam = Adam(leaves, lr)
    losses, grad_norms = [], None
    for k in range(steps):
        with unit(k):
            loss = l2_loss(p, valid, cameras, targets, width, height,
                           std_dev, pair_capacity, tile_batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [torch.zeros_like(x) if g is None else g
                     for x, g in zip(leaves, grads)]
            losses.append(float(loss.detach()))
            del loss
        if k == 0:
            grad_norms = norms(grads)
        adam.step(grads)
        del grads
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": norms(x.detach() - s
                                  for x, s in zip(leaves, start))}
