"""Each slot's index within its texel-row segment (``local``), which K1,
or K2 in its local mode, computes and writes into the meta table: the
port's plain versions (``fragment.slot_local``, and ``texel_rows`` or
``fragment_apply(local_in_kernel=True)`` given a meta table whose row 2 is
zero) against the JAX package's in-kernel scan ``_local_scan`` (run here
by a Pallas call in interpret mode over 2048-slot blocks with its SMEM
carry), against the JAX segment fill, bit for bit on every slot, and K2's
outputs and record gradient in that mode against the JAX fragment_apply.
The slot tables come from ``torch_parity.adversarial_slots``: segments
across and longer than the JAX kernel's blocks, zero-width producers,
triangles that own no slot, a single producer and a total clipped at the
capacity."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from mesh2splat_tpu.ops import conversion as JC
from mesh2splat_tpu.ops import fragment as JF
from mesh2splat_tpu.ops import segments as JS

from mesh2splat_torch import kernels
from mesh2splat_torch.ops import conversion as TC
from mesh2splat_torch.ops import fragment as TF
from mesh2splat_torch.ops import segments as TS
from mesh2splat_torch.types import Material as TMaterial
from torch_parity import (SLOT_CASES, SLOT_GEOM, adversarial_slots,
                          assert_rows_close, gathered_taps, jax_mesh_material,
                          slot_records, sphere_mesh, torch_mesh_material)

CAPS = (10007, 12288)   # not a multiple of 2048 or of a CUDA block; one is


def jax_local_scan(meta):
    """JAX ``_local_scan`` over (4, cap) f32 meta, as kernel A runs it on a
    TPU: a sequential grid of CHUNK-slot blocks carrying the last segment
    start in SMEM. The tail block is padded with the last slot's key."""
    cap = meta.shape[1]
    grid = -(-cap // JF.CHUNK)
    padded = np.pad(meta, ((0, 0), (0, grid * JF.CHUNK - cap)), mode="edge")

    def kernel(meta_ref, out_ref, carry):
        out_ref[...] = JF._local_scan(meta_ref[...], carry)

    out = pl.pallas_call(
        kernel,
        grid=(grid,),
        in_specs=[pl.BlockSpec((4, JF.CHUNK), lambda i: (0, i))],
        out_specs=pl.BlockSpec((1, JF.CHUNK), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct((1, grid * JF.CHUNK), jnp.float32),
        scratch_shapes=[pltpu.SMEM((3,), jnp.int32)],
        interpret=True,
    )(jnp.asarray(padded))
    return np.asarray(out)[0, :cap]


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("case", SLOT_CASES)
def test_slot_local_matches_jax_scan_and_fill(case, cap):
    offsets, widths, meta = adversarial_slots(case, cap, seed=cap)
    got = TF.slot_local(torch.from_numpy(meta)).numpy()
    assert got.dtype == np.float32
    scan = jax_local_scan(meta)
    np.testing.assert_array_equal(_bits(got), _bits(scan))
    fill, _ = JS.expand_monotone(jnp.asarray(offsets), jnp.asarray(widths),
                                 cap)
    np.testing.assert_array_equal(got, np.asarray(fill).astype(np.float32))
    port_fill, _ = TS.expand_monotone(torch.from_numpy(offsets),
                                      torch.from_numpy(widths), cap)
    np.testing.assert_array_equal(got, port_fill.numpy().astype(np.float32))
    if case == "long":
        assert got.max() > JF.CHUNK   # a segment longer than a JAX block
    if case == "clipped":
        assert widths.sum() > cap
    if case == "single":
        assert meta[3].sum() < cap / 2


@pytest.mark.parametrize("case", SLOT_CASES)
def test_texel_rows_plain_fills_local(case):
    """The plain K1, given row 2 zero, returns the JAX texel_rows' rows
    (which read the JAX fill's local) and leaves that local in row 2."""
    cap, res = CAPS[0], 64
    offsets, widths, meta = adversarial_slots(case, cap, seed=3)
    records = slot_records(int(meta[0].max()) + 1, res, seed=4)
    fill, _ = JS.expand_monotone(jnp.asarray(offsets), jnp.asarray(widths),
                                 cap)
    ref_meta = meta.copy()
    ref_meta[2] = np.asarray(fill)
    kw = dict(res=res, geom=SLOT_GEOM, k=4, n_rows=1 << 20)
    ref = jax.jit(functools.partial(JF.texel_rows, w_rec=0, **kw))(
        records, ref_meta)
    metaT = torch.from_numpy(meta.copy())
    assert not metaT[2].any()
    rows = TF.texel_rows(torch.from_numpy(records), metaT, **kw)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(metaT[2].numpy(), ref_meta[2])
    if case in ("mixed", "sparse_tris"):
        assert (rows.numpy() > 0).sum() > cap // 2   # covered slots


@pytest.mark.parametrize("atlas", [None, "bf16", "untextured"])
def test_conversion_local_matches_jax_fill(atlas):
    """On a converted sphere, the meta table K2 works from holds in row 2
    the JAX conversion's local (its segment fill on the CPU) on every slot:
    K1 wrote it before K2 where the material has a texture; without one K2
    receives row 2 zero, computes local and leaves it there."""
    mesh, mat = sphere_mesh(400, seed=2, tex=32)
    jm, _ = jax_mesh_material(mesh, mat)
    tm, tmat = torch_mesh_material(mesh, mat)
    if atlas == "untextured":
        tmat = TMaterial.default("cpu")
    cfg = dict(resolution=48, layers=6)
    seen = {}
    real = TF.fragment_apply

    def spy(records, tapsT, metaT, *args, **kw):
        seen["given"] = metaT.clone()
        out = real(records, tapsT, metaT, *args, **kw)
        seen["left"] = metaT.clone()
        return out

    TF.fragment_apply = spy
    try:
        TC.convert(tm, tmat, *tm.bbox(), TC.ConversionConfig(**cfg),
                   atlas=TC.pack_atlas(tmat, precision=atlas)
                   if atlas == "bf16" else None)
    finally:
        TF.fragment_apply = real
    ex = JC._expand_slots(jm, *jm.bbox(), JC.ConversionConfig(**cfg))
    meta = seen["left"].numpy()
    np.testing.assert_array_equal(meta[0], np.asarray(ex["tri_id_safe"]))
    np.testing.assert_array_equal(meta[1], np.asarray(ex["s_row_local"]))
    np.testing.assert_array_equal(meta[2], np.asarray(ex["local"]))
    given = seen["given"].numpy()
    if atlas == "untextured":
        assert not given[2].any()
        np.testing.assert_array_equal(given[[0, 1, 3]], meta[[0, 1, 3]])
    else:
        np.testing.assert_array_equal(given, meta)
    assert int(ex["total"]) > 1000


@pytest.mark.parametrize("textured", [True, False])
def test_textured_conversion_runs_one_slot_fill(textured, monkeypatch):
    """A kernel computes local (K1 where the material has a texture, K2
    where it has none), so either conversion fills only the packed
    (tri, row_local) over the slots: one fill over the slot capacity."""
    mesh, mat = sphere_mesh(300, seed=4, tex=32)
    tm, tmat = torch_mesh_material(mesh, mat)
    if not textured:
        tmat = TMaterial.default("cpu")
    cfg = TC.ConversionConfig(resolution=40, layers=6,
                              row_capacity_override=5000)
    calls = []
    real = TS.fill_value

    def counting(offsets, counts, capacity, value):
        calls.append(capacity)
        return real(offsets, counts, capacity, value)

    monkeypatch.setattr(TS, "fill_value", counting)
    TC.convert(tm, tmat, *tm.bbox(), cfg)
    slot_fills = [c for c in calls if c == cfg.capacity]
    row_fills = [c for c in calls if c == cfg.row_capacity]
    assert len(slot_fills) == 1
    assert len(row_fills) == 2   # the row expansion, unchanged
    assert len(calls) == len(slot_fills) + len(row_fills)


def _local_mode_inputs(case):
    """(records, tapsT, metaT, K2 arguments, JAX local) of K2 in local mode:
    the ones a converted sphere hands it, textured or not, or an
    adversarial slot table with slot_records' geometry and random
    attributes (no texture). metaT's row 2 is zero."""
    if case in ("textured", "untextured"):
        mesh, mat = sphere_mesh(400, seed=8, tex=32)
        tm, tmat = torch_mesh_material(mesh, mat)
        if case == "untextured":
            tmat = TMaterial.default("cpu")
        seen = {}
        real = TF.fragment_apply

        def spy(records, tapsT, metaT, *args, **kw):
            seen.update(records=records, tapsT=gathered_taps(tapsT, kw),
                        args=args)
            return real(records, tapsT, metaT, *args, **kw)

        TF.fragment_apply = spy
        try:
            TC.convert(tm, tmat, *tm.bbox(), TC.ConversionConfig(48, 6))
        finally:
            TF.fragment_apply = real
        jm, _ = jax_mesh_material(mesh, mat)
        ex = JC._expand_slots(jm, *jm.bbox(), JC.ConversionConfig(48, 6))
        meta = np.stack([np.asarray(ex[n]) for n in (
            "tri_id_safe", "s_row_local", "local", "in_budget")]).astype(
                np.float32)
        local = meta[2].copy()
        meta[2] = 0
        return (seen["records"].numpy(), seen["tapsT"].numpy(), meta,
                seen["args"][:7], local)
    offsets, widths, meta = adversarial_slots(case, CAPS[0], seed=5)
    n_tri = int(meta[0].max()) + 1
    # segments up to 4096 slots covered
    rec = slot_records(n_tri, 4096, seed=6, attrs=True)
    fill, _ = JS.expand_monotone(jnp.asarray(offsets), jnp.asarray(widths),
                                 CAPS[0])
    taps = np.zeros((1, CAPS[0]), np.float32)
    args = (4096, ((0, 1, 1, 1),), 1, False, False, False, False)
    return rec, taps, meta, args, np.asarray(fill).astype(np.float32)


@pytest.mark.parametrize("case", ["untextured", "textured", "mixed", "long",
                                  "clipped"])
def test_fragment_apply_local_matches_jax(case):
    """K2's plain version in local mode, given row 2 zero, against the JAX
    fragment_apply given the JAX conversion's local (its segment fill on
    the CPU): loc and valid exactly, and bit for bit the port's own K2
    given that local; the other outputs within K2's 2e-5 of JAX on the
    live slots (a jit of fragment_apply alone fuses other multiply-adds
    than the JAX conversion, whose choice the port repeats), and the record
    gradient within the fragment VJP's tolerance."""
    rec, taps, meta, args, local = _local_mode_inputs(case)
    res, geom, k, hb, hn, hm, packed = args
    assert not meta[2].any()
    jmeta = meta.copy()
    jmeta[2] = local

    def j_fn(r):
        return JF.fragment_apply(r, jnp.asarray(taps), jnp.asarray(jmeta),
                                 res, geom, k, hb, hn, hm, 0, False, packed)

    (ref, ref_loc), vjp = jax.vjp(j_fn, jnp.asarray(rec))
    ref = np.asarray(ref)
    metaT = torch.from_numpy(meta.copy())
    trec = torch.from_numpy(rec).requires_grad_(True)
    out, loc = TF.fragment_apply(trec, torch.from_numpy(taps), metaT, *args,
                                 local_in_kernel=True)
    assert loc.shape == (1, meta.shape[1])
    np.testing.assert_array_equal(loc.numpy(), np.asarray(ref_loc))
    np.testing.assert_array_equal(metaT.numpy(), jmeta)
    given, _ = TF.fragment_apply(torch.from_numpy(rec),
                                 torch.from_numpy(taps),
                                 torch.from_numpy(jmeta), *args)
    o = out.detach().numpy()
    np.testing.assert_array_equal(o.view(np.int32),
                                  given.numpy().view(np.int32))
    np.testing.assert_array_equal(o[19], ref[19])
    live = ref[19] > 0
    assert live.sum() > 1000
    assert np.abs(o[:19, live] - ref[:19, live]).max() <= 2e-5

    g = (np.random.default_rng(3).normal(size=o.shape) * live).astype(
        np.float32)
    g[19] = 0.0
    (ref_rec,) = vjp((jnp.asarray(g), jnp.zeros_like(ref_loc)))
    out.backward(torch.from_numpy(g))
    ref_rec = np.asarray(ref_rec)
    assert np.abs(ref_rec).max() > 0
    assert_rows_close(trec.grad.numpy()[:58], ref_rec[:58], 1e-3, "records")


@pytest.mark.parametrize("k", [0, 3, 6, 12])
def test_k1_wrapper_rejects_k_not_power_of_two(k):
    """K1 divides by k with a shift: its wrapper refuses any other k before
    it looks at the tensors or launches anything (pack_factor gives powers
    of two only)."""
    _, _, meta = adversarial_slots("mixed", 3001, seed=1)
    rec = torch.from_numpy(slot_records(int(meta[0].max()) + 1, 64))
    before = dict(kernels.launches)
    with pytest.raises(ValueError, match="power of two"):
        kernels.texel_rows(rec, torch.from_numpy(meta), res=64,
                           geom=SLOT_GEOM, k=k, n_rows=1 << 20)
    assert kernels.launches == before
    assert all(TF.pack_factor(n) & (TF.pack_factor(n) - 1) == 0
               for n in (1, 4096, 1 << 20, 3 << 21, 1 << 24))
