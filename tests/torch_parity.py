"""Shared inputs for the port-vs-reference tests (tests/test_torch_*.py):
small textured meshes made in numpy from a seed, handed to both the JAX
package and mesh2splat_torch, and a host view of JAX dataclasses."""

from __future__ import annotations

import dataclasses

import numpy as np


def host(obj) -> dict:
    """{field: numpy array} of a JAX (or port) dataclass instance."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = v.detach().cpu().numpy() if hasattr(v, "detach") \
            else np.asarray(v)
    return out


def assert_rows_close(got, ref, rel, what=""):
    """Each row (a field, or a gradient of one splat field) within ``rel``
    of that row's largest magnitude."""
    got, ref = np.asarray(got), np.asarray(ref)
    scale = np.abs(ref).reshape(ref.shape[0], -1).max(axis=1)
    diff = np.abs(got - ref).reshape(ref.shape[0], -1).max(axis=1)
    bad = diff > rel * np.maximum(scale, 1e-30)
    assert not bad.any(), (what, diff[bad], scale[bad])


def gathered_taps(tapsT, kw):
    """The taps a fragment_apply call shades with, one column a slot: tapsT
    itself, or, when the call passes K1's rows, the atlas columns they
    name."""
    rows = kw.get("rows")
    return tapsT if rows is None else tapsT.index_select(1, rows)


def sphere_mesh(n_tri=600, seed=0, tex=32, uv_scale=0.25):
    """A perturbed lat-long sphere (bench.py's workload shape at small size)
    with base-colour, normal and metallic-roughness textures, as numpy."""
    rng = np.random.default_rng(seed)
    rows = int(np.sqrt(n_tri / 2))
    cols = (n_tri // 2) // max(rows, 1)
    th = np.linspace(0.15, np.pi - 0.15, rows + 1)
    ph = np.linspace(0, 2 * np.pi, cols + 1)
    t, p = np.meshgrid(th, ph, indexing="ij")
    r = 1.0 + 0.05 * rng.standard_normal(t.shape)
    verts = np.stack([r * np.sin(t) * np.cos(p), r * np.cos(t),
                      r * np.sin(t) * np.sin(p)], -1).astype(np.float32)
    quads = []
    for i in range(rows):
        for j in range(cols):
            a, b = verts[i, j], verts[i + 1, j]
            c, d = verts[i + 1, j + 1], verts[i, j + 1]
            quads += [(a, b, c), (a, c, d)]
    tri_pos = np.asarray(quads, np.float32)[:n_tri]
    fn = np.cross(tri_pos[:, 1] - tri_pos[:, 0], tri_pos[:, 2] - tri_pos[:, 0])
    fn /= np.linalg.norm(fn, axis=-1, keepdims=True) + 1e-12
    # a tangent orthogonal to the face normal keeps the TBN frame well
    # conditioned (a fixed (1, 0, 0) tangent degenerates where the normal
    # turns along x, and there the last bits of any two arithmetics part)
    tan = np.cross(np.asarray([0, 1, 0], np.float32), fn)
    tan /= np.linalg.norm(tan, axis=-1, keepdims=True)
    tan4 = np.concatenate([tan, np.ones_like(tan[:, :1])], -1)
    mesh = dict(
        tri_pos=tri_pos,
        tri_normal=np.repeat(fn[:, None], 3, axis=1).astype(np.float32),
        tri_tangent=np.repeat(tan4[:, None], 3, axis=1).astype(np.float32),
        tri_uv=(tri_pos[..., :2] * uv_scale + 0.5).astype(np.float32),
    )
    material = dict(
        base_color_factor=np.asarray([0.9, 0.8, 1.0, 1.0], np.float32),
        metallic_factor=np.float32(1.0),
        roughness_factor=np.float32(1.0),
        base_color=rng.uniform(0, 1, (tex, tex, 4)).astype(np.float32),
        # a tangent-space normal map as assets have them (z near 1, as in
        # tests/golden_asset.py): a map whose vectors shrink towards 0
        # amplifies the last bits of the filtering in the normalisation
        normal=np.concatenate([rng.uniform(0.4, 0.6, (tex, tex, 2)),
                               np.full((tex, tex, 1), 0.9)], -1)
        .astype(np.float32),
        metallic_roughness=rng.uniform(0, 1, (tex, tex, 3)).astype(np.float32),
        has_base_color=True, has_normal=True, has_metallic_roughness=True,
    )
    return mesh, material


def jax_mesh_material(mesh: dict, material: dict):
    import jax.numpy as jnp

    from mesh2splat_tpu.types import Material, TriangleMesh

    jm = TriangleMesh(**{k: jnp.asarray(v) for k, v in mesh.items()})
    jmat = Material(**{k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                           else v) for k, v in material.items()})
    return jm, jmat


def torch_mesh_material(mesh: dict, material: dict, device="cpu"):
    from mesh2splat_torch import state

    return state.mesh(mesh, device), state.material(material, device)


def slot_meta(widths, tris, rows, cap):
    """The slot table a conversion hands K1, from row producers in
    allocation order: producer p (triangle tris[p], texel row rows[p]; the
    keys strictly increase) owns widths[p] >= 0 slots from its exclusive
    cumsum offset, clipped at cap; slots past the total repeat the last key
    and are not live. Returns (offsets, widths, metaT): int32 (P,) arrays
    and a (4, cap) f32 array [tri, row_local, 0, live]."""
    widths = np.asarray(widths, np.int32)
    offsets = (np.cumsum(widths) - widths).astype(np.int32)
    owner = np.repeat(np.arange(len(widths)), widths)[:cap]
    total = len(owner)
    owner = np.concatenate([owner, np.full(cap - total, owner[-1])])
    meta = np.zeros((4, cap), np.float32)
    meta[0] = np.asarray(tris)[owner]
    meta[1] = np.asarray(rows)[owner]
    meta[3] = np.arange(cap) < total
    return offsets, widths, meta


SLOT_CASES = ("mixed", "long", "sparse_tris", "single", "clipped",
              "block_edges", "unit")


def adversarial_slots(case, cap, seed=0):
    """slot_meta for one case of SLOT_CASES: short segments with zero-width
    producers, segments longer than 2048 slots (the JAX kernel's block) and
    than a CUDA block, triangle ids that skip many triangles, a single
    producer (most slots past the total), a total clipped at cap, segment
    edges on block edges, and one slot a segment."""
    rng = np.random.default_rng(seed)
    n = cap  # more producers than the capacity needs
    if case == "mixed":
        widths = rng.integers(0, 13, n) * (rng.random(n) > 0.2)
    elif case == "long":
        widths = np.where(rng.random(n) < 0.1, rng.integers(2049, 6000, n),
                          rng.integers(0, 40, n))
    elif case == "sparse_tris":
        widths = rng.integers(0, 30, n)
    elif case == "single":
        widths = np.array([cap // 3])
    elif case == "clipped":
        widths = rng.integers(100, 3000, n)
    elif case == "block_edges":
        widths = rng.choice([1, 31, 32, 33, 1023, 1024, 1025, 2048], n)
    elif case == "unit":
        widths = np.ones(n, np.int64)
    else:
        raise ValueError(case)
    widths = widths.astype(np.int64)
    keep = np.cumsum(widths) - widths < cap + 1
    widths = widths[keep]
    p = len(widths)
    per_tri = rng.integers(1, 6, p)
    tri_step = rng.integers(0, 2, p)
    if case == "sparse_tris":
        tri_step *= rng.integers(50, 500, p)
    # a new triangle when the step is taken, else the next row of this one
    new_tri = (tri_step > 0) | (np.arange(p) % per_tri == 0)
    tris = np.cumsum(np.where(new_tri, np.maximum(tri_step, 1), 0))
    start = np.maximum.accumulate(np.where(new_tri, np.arange(p), 0))
    rows = np.arange(p) - start
    return slot_meta(widths, tris - tris[0], rows, cap)


SLOT_GEOM = ((0, 64, 64, 4096), (1024, 32, 32, 1024))  # (off, h, w, hw_pad)


def slot_records(n_tri, res, seed=0, attrs=False):
    """A (64, T_pad) f32 record table for K1 whose triangles cover the
    whole ortho-UV square (texel box 0..res-1 in x and y), so that most
    slots of slot_meta are covered; random texture uv, mip level 0 or 1 of
    SLOT_GEOM, material 0. attrs: random position, normal, tangent, quat,
    scale and colour-factor rows too, for K2."""
    rng = np.random.default_rng(seed)
    t_pad = -(-(n_tri + 128) // 128) * 128
    rec = np.zeros((64, t_pad), np.float32)
    jit = rng.uniform(-0.01, 0.01, (6, n_tri))
    rec[0:6, :n_tri] = np.array([0, 0, 2, 0, 0, 2])[:, None] + jit
    rec[8, :n_tri] = res                     # tw (tx0 = ty0 = 0)
    rec[9:15, :n_tri] = rng.uniform(-0.5, 1.5, (6, n_tri))
    rec[16, :n_tri] = rng.integers(0, 2, n_tri)
    if attrs:
        rec[17:58, :n_tri] = rng.uniform(-1, 1, (41, n_tri))
    return rec
