"""Data parallelism over torch.distributed (counterpart of
``mesh2splat_tpu.parallel.sharding``).

The JAX package runs one program over a ``jax.sharding.Mesh`` of devices
(shard_map); PyTorch runs one process per device. So a mesh here is a
``torch.distributed.device_mesh.DeviceMesh`` over the processes of the
default group, each process holds the full inputs and takes its own
contiguous block of what ``P("dp")`` would shard, and the collectives are
explicit:

- conversion sharded over triangles (``convert_sharded``): each rank
  converts its block of triangles against the full textures and keeps its
  own shard of the splats, no communication;
- rendering sharded over image bands (``rasterize_sharded``): each rank
  renders its band of rows, no communication;
- training data-parallel over views (``train.fit.fit_splats(devices_mesh=)``
  and ``train_step_fn(mesh=)``): the loss and the gradients are averaged
  over the ranks with ``all_reduce`` before Adam (``mean_over``).

NCCL joins processes on CUDA cards, gloo on the CPU (``init_distributed``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..ops.conversion import ConversionConfig, convert
from ..ops.projection import ProjectedSplats
from ..render.binning import TILE_H
from ..render.tiled import rasterize_tiled
from ..types import Material, Splats, TriangleMesh, resolve_device, to_device


def init_distributed(coordinator_address: str, num_processes: int,
                     process_id: int, platform: str | None = None) -> None:
    """Join ``num_processes`` processes as rank ``process_id`` through the
    rendezvous at ``coordinator_address`` ("host:port", or any init_method
    URL such as ``file://...`` or ``env://``). ``platform="cpu"`` joins
    them with gloo; otherwise with NCCL, one CUDA card a process (card
    ``process_id`` modulo the cards of the host)."""
    if platform == "cpu":
        backend = "gloo"
    else:
        resolve_device("cuda")
        backend = "nccl"
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    init = (coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=process_id)


def global_mesh(axis_shape: tuple[int, ...] | None = None,
                axis_names: tuple[str, ...] = ("dp",)) -> DeviceMesh:
    """A mesh over every process of the default group (after
    ``init_distributed``, or ``torchrun``'s own init); ``axis_shape``
    defaults to one axis over all of them. Its device type is cuda under
    NCCL and cpu under gloo."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed (or "
                           "torch.distributed.init_process_group) first")
    shape = (tuple(axis_shape) if axis_shape is not None
             else (dist.get_world_size(),))
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=tuple(axis_names))


def make_mesh(n_devices: int | None = None, axis: str = "dp") -> DeviceMesh:
    """A one-axis mesh over the ``n_devices`` processes of the default
    group (all of them by default): one process is one device, so this is
    ``global_mesh((n,), (axis,))`` and ``n`` must be the world size."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed (or "
                           "torch.distributed.init_process_group) first")
    n = n_devices or dist.get_world_size()
    if n != dist.get_world_size():
        raise ValueError(f"a mesh of {n} devices needs {n} processes, the "
                         f"group has {dist.get_world_size()}")
    return global_mesh((n,), (axis,))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This process's device in ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_rank(mesh: DeviceMesh, axis: str = "dp") -> tuple[int, int]:
    """(this process's index along ``axis``, the axis's size)."""
    return mesh.get_local_rank(axis), dist.get_world_size(mesh.get_group(axis))


def mean_over(t: torch.Tensor, mesh: DeviceMesh, axis: str = "dp"):
    """In place: ``t`` becomes the mean over the ranks of ``axis`` of their
    ``t`` (all_reduce of the sum, then a division by the count; exact for
    one rank). Returns ``t``. NCCL reduces contiguous tensors only, so a
    strided ``t`` (a gradient of a slice) goes through a contiguous copy."""
    buf = t.contiguous()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
    buf.div_(axis_rank(mesh, axis)[1])
    return t if buf is t else t.copy_(buf)


def max_over(t: torch.Tensor, mesh: DeviceMesh, axis: str = "dp"):
    """In place: ``t`` becomes the maximum over the ranks of ``axis``."""
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.get_group(axis))
    return t


def _map(fn, tree):
    """``fn`` applied to every tensor of a tensor, a dataclass of tensors or
    a list / tuple of them; other values are kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)
            if isinstance(getattr(tree, f.name), torch.Tensor)})
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def pad_to_multiple(a: torch.Tensor, m: int, axis: int = 0) -> torch.Tensor:
    """``a`` zero-padded along ``axis`` to a multiple of ``m``."""
    pad = (-a.shape[axis]) % m
    if pad == 0:
        return a
    shape = list(a.shape)
    shape[axis] = pad
    return torch.cat([a, a.new_zeros(shape)], dim=axis)


def _block(a, rank: int, n: int):
    if len(a) % n:
        raise ValueError(f"a leading dimension of {len(a)} does not split "
                         f"into {n} equal shards")
    b = len(a) // n
    return a[rank * b:(rank + 1) * b]


def replicate(tree, mesh: DeviceMesh):
    """``tree`` on this process's device of ``mesh`` (every process holds
    the full value)."""
    dev = mesh_device(mesh)
    return _map(lambda t: t.to(dev), tree)


def shard_batch(tree, mesh: DeviceMesh, axis: str = "dp"):
    """This rank's contiguous block of the leading (batch) dimension, on
    its device: of a tensor, of each tensor of a dataclass, or of a list
    (e.g. one camera a view). The leading dimension must split evenly."""
    rank, n = axis_rank(mesh, axis)
    if isinstance(tree, list):
        return replicate(_block(tree, rank, n), mesh)
    return replicate(_map(lambda t: _block(t, rank, n), tree), mesh)


def put_global(tree, mesh: DeviceMesh, spec: str | None = None):
    """The JAX package's put_global fills each process's shards of a global
    array from the full value every process passes. With one process a
    device each process already holds only its own shard, so this has no
    job of its own: ``replicate`` for ``spec=None`` (``P()``),
    ``shard_batch`` over the axis ``spec`` names otherwise (``P(axis)``)."""
    return replicate(tree, mesh) if spec is None else shard_batch(
        tree, mesh, spec)


def shard_triangles(mesh_geom: TriangleMesh, mesh: DeviceMesh,
                    axis: str = "dp") -> TriangleMesh:
    """The triangle soup zero-padded to a multiple of the ranks, and this
    rank's block of it."""
    n = axis_rank(mesh, axis)[1]
    return shard_batch(_map(lambda t: pad_to_multiple(t, n), mesh_geom),
                       mesh, axis)


def convert_sharded(mesh_geom: TriangleMesh, material: Material, bbox_min,
                    bbox_max, config: ConversionConfig, mesh: DeviceMesh,
                    axis: str = "dp") -> Splats:
    """Conversion sharded over triangles: this rank converts its padded
    block of triangles against the full textures (``config.capacity``
    slots) and returns its own shard of the splats. The shards of the
    ranks, concatenated in rank order, are the JAX function's global
    array. No communication."""
    dev = mesh_device(mesh)
    geom = shard_triangles(mesh_geom, mesh, axis)
    lo = torch.as_tensor(bbox_min, dtype=torch.float32, device=dev)
    hi = torch.as_tensor(bbox_max, dtype=torch.float32, device=dev)
    return convert(geom, to_device(material, dev), lo, hi, config)


def rasterize_sharded(proj: ProjectedSplats, width: int, height: int,
                      mesh: DeviceMesh, axis: str = "dp",
                      pair_capacity: int = 0, albedo_only: bool = False):
    """Rasterize with the image sharded over bands of rows: this rank
    renders rows [r * height / n, (r + 1) * height / n) of the full image
    (rank 0 at the top) from all the splats, and returns that band's
    premultiplied albedo, (height / n, width, 4). The bands in rank order
    are the full image. Raises unless n * TILE_H divides ``height``.

    Each band is the full frame's tiled raster with the splats' NDC y
    shifted so that the band maps to rows [0, height / n):
    ``y_band = n * y + (2 r + 1 - n)``, the JAX package's pixel shift in
    closed form (the identity for one rank). No communication in the
    forward; a gradient reaches this rank's ``proj`` only, so sum it over
    the ranks for the full image's."""
    rank, n = axis_rank(mesh, axis)
    band_h = height // n
    if band_h * n != height or band_h % TILE_H != 0:
        raise ValueError(f"height {height} must be divisible by "
                         f"n_devices*TILE_H ({n}*{TILE_H})")
    proj = replicate(proj, mesh)
    y = proj.mean_ndc[:, 1] * n + float(2 * rank + 1 - n)
    shifted = dataclasses.replace(
        proj, mean_ndc=torch.stack([proj.mean_ndc[:, 0], y], -1))
    out = rasterize_tiled(shifted, width, band_h,
                          pair_capacity=pair_capacity,
                          albedo_only=albedo_only)
    return out["albedo"]
