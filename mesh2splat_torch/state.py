"""State carried across from the JAX package: its pytrees (``TriangleMesh``,
``Material``, ``Splats``, ``Camera``, ``ProjectedSplats``, ``ShadowCubemap``),
given as dicts of numpy arrays or as objects whose fields read as arrays,
become the port's dataclasses of tensors on a chosen device;
``splats_to_numpy`` and ``gbuffer_to_numpy`` go the other way. The system
has no weights: the mesh, the material and the splats are its state.

This module imports neither jax nor the JAX package: it reads fields by name
with ``numpy.asarray``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ops.projection import ProjectedSplats
from .render.shadows import ShadowCubemap
from .types import Camera, Material, Splats, TriangleMesh, resolve_device


def _fields(src) -> dict:
    if isinstance(src, dict):
        return src
    return {f.name: getattr(src, f.name) for f in dataclasses.fields(src)}


def from_numpy(cls, src, device="cuda"):
    """A port dataclass ``cls`` from ``src`` (dict or dataclass instance):
    tensor fields become float/int/bool tensors on ``device`` (copied),
    scalar fields Python scalars; fields missing from ``src`` keep the
    port's default."""
    dev = resolve_device(device)
    vals = _fields(src)
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in vals:
            continue
        v = vals[f.name]
        kind = f.type if isinstance(f.type, str) else f.type.__name__
        if "Tensor" in kind:
            kw[f.name] = torch.from_numpy(np.array(v)).to(dev)
        elif kind in ("float", "int", "bool"):
            kw[f.name] = {"float": float, "int": int, "bool": bool}[kind](
                np.asarray(v).item())
        else:
            kw[f.name] = v
    return cls(**kw)


def mesh(src, device="cuda") -> TriangleMesh:
    return from_numpy(TriangleMesh, src, device)


def material(src, device="cuda") -> Material:
    return from_numpy(Material, src, device)


def splats(src, device="cuda") -> Splats:
    return from_numpy(Splats, src, device)


def camera(src, device="cuda") -> Camera:
    return from_numpy(Camera, src, device)


def projected(src, device="cuda") -> ProjectedSplats:
    return from_numpy(ProjectedSplats, src, device)


def shadow_cubemap(src, device="cuda"):
    """The JAX package's ShadowCubemap (faces, light_pos, far) -> the
    port's."""
    return from_numpy(ShadowCubemap, src, device)


def cameras(src, device="cuda") -> list:
    """A camera batch stacked over views (the JAX package's batched camera
    pytree: (V, 4, 4) matrices, (V,) near and far, one width and height)
    -> one port Camera per view."""
    vals = _fields(src)
    w2v = np.asarray(vals["world_to_view"])
    near, far = np.asarray(vals["near"]), np.asarray(vals["far"])
    return [camera(dict(world_to_view=w2v[i],
                        view_to_clip=np.asarray(vals["view_to_clip"])[i],
                        near=near[i], far=far[i], width=vals["width"],
                        height=vals["height"]), device)
            for i in range(w2v.shape[0])]


def splat_params(src, device="cuda"):
    """The JAX package's SplatParams (or a dict of its fields) -> the port's
    SplatParams of leaf tensors that require grad."""
    from .train.fit import SplatParams

    sp = from_numpy(SplatParams, src, device)
    return SplatParams(**{k: v.requires_grad_(True)
                          for k, v in sp.as_dict().items()})


def params_to_numpy(params) -> dict:
    """SplatParams (or any dataclass of tensors) on the host."""
    return {f.name: getattr(params, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(params)}


def splats_to_numpy(sp: Splats) -> dict:
    """All capacity rows of every field, on the host."""
    return {f.name: getattr(sp, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(sp)}


def gbuffer_to_numpy(gbuffer) -> dict | np.ndarray:
    """A G-buffer dict (or one tensor, e.g. the raw (16, H, W) composite
    output) on the host."""
    if isinstance(gbuffer, torch.Tensor):
        return gbuffer.detach().cpu().numpy()
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else v) for k, v in gbuffer.items()}
