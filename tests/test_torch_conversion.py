"""Conversion in mesh2splat_torch vs mesh2splat_tpu: the plain versions of
K1 (texel_rows) and K2 (fragment_apply) on the same records, and convert /
convert_packed end to end, on small meshes made from a seed, textured and
untextured, through the packed slot key and through the large-mesh
branch."""

import functools

import jax
import numpy as np
import pytest
import torch

from mesh2splat_tpu.ops import conversion as JC
from mesh2splat_tpu.ops import fragment as JF
from mesh2splat_tpu.types import Material as JMaterial

from mesh2splat_torch import state
from mesh2splat_torch.ops import conversion as TC
from mesh2splat_torch.ops import fragment as TF
from mesh2splat_torch.ops import segments as TS
from mesh2splat_torch.types import Material as TMaterial
from torch_parity import host, jax_mesh_material, sphere_mesh, \
    torch_mesh_material

SPLAT_FIELDS = ("pos", "color", "scale", "normal", "quat", "pbr")


def _convert_inputs(n_tri=400, res=48, textured=True, atlas=None, seed=0):
    """Port conversion of a small sphere, capturing the record table,
    metaT and gathered taps its fragment kernels receive."""
    mesh, mat = sphere_mesh(n_tri, seed=seed, tex=32)
    tm, tmat = torch_mesh_material(mesh, mat)
    if not textured:
        tmat = TMaterial.default("cpu")
    seen = {}
    real = TF.fragment_apply

    def spy(records, tapsT, metaT, *args, **kw):
        seen.update(records=records, tapsT=tapsT, metaT=metaT, args=args)
        return real(records, tapsT, metaT, *args, **kw)

    cfg = TC.ConversionConfig(resolution=res, layers=6)
    lo, hi = tm.bbox()
    pack = TC.pack_atlas(tmat, precision=atlas) if atlas else None
    TF.fragment_apply = spy
    try:
        TC.convert(tm, tmat, lo, hi, cfg, atlas=pack)
    finally:
        TF.fragment_apply = real
    return seen


@pytest.mark.parametrize("atlas", [None, "bf16"])
def test_texel_rows_plain_exact(atlas):
    """K1 plain on the CPU equals the JAX texel_rows exactly."""
    s = _convert_inputs(atlas=atlas)
    res, geom, k = s["args"][0], s["args"][1], s["args"][2]
    n_rows = 1 << 20
    out = TF.texel_rows(s["records"], s["metaT"], res=res, geom=geom, k=k,
                        n_rows=n_rows)
    ref = jax.jit(functools.partial(
        JF.texel_rows, res=res, geom=geom, k=k, n_rows=n_rows, w_rec=0))(
        s["records"].numpy(), s["metaT"].numpy())
    assert out.dtype == torch.int32
    assert int((s["metaT"][3] > 0).sum()) > 1000
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("textured,atlas", [
    (True, None), (True, "bf16"), (True, "f32"), (False, None)])
def test_fragment_apply_plain_matches(textured, atlas):
    """K2 plain: valid exact, every float within 2e-5 on the live slots."""
    s = _convert_inputs(textured=textured, atlas=atlas)
    res, geom, k, hb, hn, hm, packed = s["args"]
    out, _ = TF.fragment_apply(s["records"], s["tapsT"], s["metaT"], res,
                               geom, k, hb, hn, hm, packed)
    ref, _ = jax.jit(lambda r, t, m: JF.fragment_apply(
        r, t, m, res, geom, k, hb, hn, hm, 0, False, packed))(
        s["records"].numpy(), s["tapsT"].numpy(), s["metaT"].numpy())
    ref = np.asarray(ref)
    out = out.numpy()
    np.testing.assert_array_equal(out[19], ref[19])
    live = ref[19] > 0
    assert live.sum() > 1000
    diff = np.abs(out[:19, live] - ref[:19, live]).max()
    print(f"K2 plain vs JAX (textured={textured}, atlas={atlas}): {diff:.3g}")
    assert diff <= 2e-5


def _compare_splats(ts, js):
    tv, jv = ts.valid.numpy(), np.asarray(js.valid)
    assert int(ts.count()) == int(js.count())
    np.testing.assert_array_equal(tv, jv)
    th, jh = host(ts), host(js)
    for f in SPLAT_FIELDS:
        np.testing.assert_allclose(th[f][jv], jh[f][jv], atol=2e-5, rtol=0,
                                   err_msg=f)


@pytest.mark.parametrize("res,mips", [(48, True), (96, True), (64, False)])
def test_convert_matches(res, mips):
    mesh, mat = sphere_mesh(500, seed=res, tex=64)
    jm, jmat = jax_mesh_material(mesh, mat)
    tm, tmat = torch_mesh_material(mesh, mat)
    cfg = dict(resolution=res, layers=6, use_mips=mips)
    jcfg = JC.calibrate(jm, *jm.bbox(), JC.ConversionConfig(**cfg))
    tcfg = TC.calibrate(tm, *tm.bbox(), TC.ConversionConfig(**cfg))
    assert (tcfg.capacity, tcfg.row_capacity) == (jcfg.capacity,
                                                  jcfg.row_capacity)
    js, jst = JC.convert(jm, jmat, *jm.bbox(), jcfg, return_stats=True)
    ts, tst = TC.convert(tm, tmat, *tm.bbox(), tcfg, return_stats=True)
    _compare_splats(ts, js)
    for key in ("dropped_rows", "dropped_slots", "dropped_window"):
        assert int(tst[key]) == int(jst[key]) == 0


def test_convert_packed_matches():
    """Two primitives, one textured and one plain, in one fused pass."""
    m1, mat1 = sphere_mesh(300, seed=5, tex=32)
    m2, _ = sphere_mesh(200, seed=6)
    m2["tri_pos"] = m2["tri_pos"] * 0.5 + np.float32(1.5)
    jprims = [jax_mesh_material(m1, mat1),
              (jax_mesh_material(m2, mat1)[0], JMaterial.default())]
    tprims = [torch_mesh_material(m1, mat1),
              (state.mesh(m2, "cpu"), TMaterial.default("cpu"))]
    cfg = dict(resolution=64, layers=4)
    js, jst = JC.convert_packed(jprims, JC.ConversionConfig(**cfg),
                                calibrate_budget=True, return_stats=True)
    ts, tst = TC.convert_packed(tprims, TC.ConversionConfig(**cfg),
                                calibrate_budget=True, return_stats=True)
    assert ts.capacity == js.capacity
    _compare_splats(ts, js)
    assert int(tst["dropped_slots"]) == int(jst["dropped_slots"]) == 0


@pytest.mark.parametrize("res", [48, 96])
def test_convert_untextured_matches(res):
    """A material without maps (Material.default): no K1, K2 computes each
    slot's local. Count and valid exact, splats within 2e-5."""
    mesh, mat = sphere_mesh(500, seed=res + 1)
    jm, _ = jax_mesh_material(mesh, mat)
    tm = state.mesh(mesh, "cpu")
    cfg = dict(resolution=res, layers=6)
    jcfg = JC.calibrate(jm, *jm.bbox(), JC.ConversionConfig(**cfg))
    tcfg = TC.calibrate(tm, *tm.bbox(), TC.ConversionConfig(**cfg))
    assert tcfg.capacity == jcfg.capacity
    js, jst = JC.convert(jm, JMaterial.default(), *jm.bbox(), jcfg,
                         return_stats=True)
    ts, tst = TC.convert(tm, TMaterial.default("cpu"), *tm.bbox(), tcfg,
                         return_stats=True)
    assert int(ts.count()) > 1000
    _compare_splats(ts, js)
    for key in ("dropped_rows", "dropped_slots", "dropped_window"):
        assert int(tst[key]) == int(jst[key]) == 0


@pytest.mark.parametrize("textured", [True, False])
def test_large_mesh_branch_matches(textured, monkeypatch):
    """The branch for meshes whose packed slot key would overflow
    (t * 4096 >= PACKED_KEY_LIMIT, forced here on a small mesh): it keeps
    the local that expand_to_slots computes in metaT's row 2, runs no fill
    of the slot capacity and no K2 scan on top, and gives the same splats
    as the packed branch (bit for bit) and as the JAX convert."""
    mesh, mat = sphere_mesh(400, seed=11, tex=32)
    jm, jmat = jax_mesh_material(mesh, mat)
    tm, tmat = torch_mesh_material(mesh, mat)
    if not textured:
        jmat, tmat = JMaterial.default(), TMaterial.default("cpu")
    cfg = TC.ConversionConfig(resolution=48, layers=6,
                              row_capacity_override=5000)
    packed = TC.convert(tm, tmat, *tm.bbox(), cfg)

    seen, fills = {}, []
    real_apply, real_fill = TF.fragment_apply, TS.fill_value

    def spy(records, tapsT, metaT, *args, **kw):
        seen.update(given=metaT.clone(), **kw)
        return real_apply(records, tapsT, metaT, *args, **kw)

    def counting(offsets, counts, capacity, value):
        fills.append(capacity)
        return real_fill(offsets, counts, capacity, value)

    monkeypatch.setattr(TC, "PACKED_KEY_LIMIT", 0)
    monkeypatch.setattr(TF, "fragment_apply", spy)
    monkeypatch.setattr(TS, "fill_value", counting)
    large = TC.convert(tm, tmat, *tm.bbox(), cfg)
    assert seen["local_in_kernel"] is False
    assert fills == [cfg.row_capacity] * 2   # the row expansion only
    ex = TC._expand_slots(tm, *tm.bbox(), cfg)
    assert ex["local"] is not None
    if not textured:   # K1 overwrites row 2 with the same values
        np.testing.assert_array_equal(seen["given"][2].numpy(),
                                      ex["local"].numpy().astype(np.float32))
    for f in SPLAT_FIELDS + ("valid",):
        assert torch.equal(getattr(large, f), getattr(packed, f)), f
    _compare_splats(large, JC.convert(
        jm, jmat, *jm.bbox(), JC.ConversionConfig(
            resolution=48, layers=6, row_capacity_override=5000)))
