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
from torch_parity import gathered_taps, host, jax_mesh_material, \
    sphere_mesh, torch_mesh_material

SPLAT_FIELDS = ("pos", "color", "scale", "normal", "quat", "pbr")


# FAST_ROWS that make pack_factor pack k texels an atlas row of a 32^2
# texture (1024 texels), and the maps each case of MAPS leaves out
K_FAST_ROWS = {1: TF.FAST_ROWS, 2: 600, 4: 300}
MAPS = {"all": (), "base": ("has_normal", "has_metallic_roughness"),
        "normal": ("has_base_color", "has_metallic_roughness"),
        "mr": ("has_base_color", "has_normal")}


def _convert_inputs(n_tri=400, res=48, textured=True, atlas=None, seed=0,
                    k=1, maps="all"):
    """Port conversion of a small sphere, capturing the record table,
    metaT, the tap atlas and K1's rows its fragment kernel receives, and
    the taps they gather. k: texels an atlas row (pack_factor's, through
    FAST_ROWS); maps: a key of MAPS."""
    mesh, mat = sphere_mesh(n_tri, seed=seed, tex=32)
    mat.update({name: False for name in MAPS[maps]})
    tm, tmat = torch_mesh_material(mesh, mat)
    if not textured:
        tmat = TMaterial.default("cpu")
    seen = {}
    real = TF.fragment_apply

    def spy(records, tapsT, metaT, *args, **kw):
        seen.update(records=records, tapsT=gathered_taps(tapsT, kw),
                    atlasT=tapsT, rows=kw.get("rows"), metaT=metaT,
                    args=args)
        return real(records, tapsT, metaT, *args, **kw)

    cfg = TC.ConversionConfig(resolution=res, layers=6)
    lo, hi = tm.bbox()
    fast_rows = TF.FAST_ROWS
    TF.fragment_apply, TF.FAST_ROWS = spy, K_FAST_ROWS[k]
    try:
        pack = TC.pack_atlas(tmat, precision=atlas) if atlas else None
        TC.convert(tm, tmat, lo, hi, cfg, atlas=pack)
    finally:
        TF.fragment_apply, TF.FAST_ROWS = real, fast_rows
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


@pytest.mark.parametrize("atlas,k,maps", [
    (atlas, k, "all") for atlas in (None, "bf16") for k in (1, 2, 4)]
    + [(atlas, 2, maps) for atlas in (None, "bf16")
       for maps in ("base", "normal", "mr")])
def test_fragment_apply_rows_matches(atlas, k, maps):
    """K2 as the conversion calls it, reading the tap atlas by K1's rows:
    bit-equal to the same call on atlasT.index_select(1, rows) (the taps
    gathered first, as the JAX package does), and against the JAX
    fragment_apply on atlasT[:, rows] valid exact, every float within 2e-5
    on the live slots (test_fragment_apply_plain_matches' bounds). f32
    atlases (the conversion's own) and packed ones (bf16 pairs, a prebuilt
    PackedAtlas), k texels an atlas row, each map present or absent."""
    s = _convert_inputs(atlas=atlas, k=k, maps=maps)
    res, geom, kk, hb, hn, hm, packed = s["args"]
    assert kk == k and packed == (atlas == "bf16")
    assert [not f for f in (hb, hn, hm)] == [
        n in MAPS[maps] for n in ("has_base_color", "has_normal",
                                  "has_metallic_roughness")]
    records, atlasT, rows, metaT = (s[n] for n in ("records", "atlasT",
                                                   "rows", "metaT"))
    assert rows.dtype == torch.int32 and rows.shape == (metaT.shape[1],)
    assert atlasT.shape[0] == k * 40 // (2 if packed else 1)
    args = (res, geom, k, hb, hn, hm, packed)
    out, _ = TF.fragment_apply(records, atlasT, metaT, *args, rows=rows)
    first, _ = TF.fragment_apply(records, atlasT.index_select(1, rows),
                                 metaT, *args)
    assert torch.equal(out.view(torch.int32), first.view(torch.int32))
    ref, _ = jax.jit(lambda r, t, m: JF.fragment_apply(
        r, t, m, res, geom, k, hb, hn, hm, 0, False, packed))(
        records.numpy(), atlasT.numpy()[:, rows.numpy()], metaT.numpy())
    ref = np.asarray(ref)
    out = out.numpy()
    np.testing.assert_array_equal(out[19], ref[19])
    live = ref[19] > 0
    assert live.sum() > 1000
    diff = np.abs(out[:19, live] - ref[:19, live]).max()
    print(f"K2 with rows vs JAX (atlas={atlas}, k={k}, maps={maps}): "
          f"{diff:.3g}")
    assert diff <= 2e-5


@pytest.mark.parametrize("k", [2, 4])
def test_convert_k_matches(k, monkeypatch):
    """The textured conversion with k texels an atlas row (both packages'
    pack_factor steered by FAST_ROWS): the same splats as the JAX convert,
    K2 reading the atlas by K1's rows."""
    mesh, mat = sphere_mesh(400, seed=20 + k, tex=32)
    jm, jmat = jax_mesh_material(mesh, mat)
    tm, tmat = torch_mesh_material(mesh, mat)
    monkeypatch.setattr(TF, "FAST_ROWS", K_FAST_ROWS[k])
    monkeypatch.setattr(JF, "FAST_ROWS", K_FAST_ROWS[k])
    assert TF.pack_factor(32 * 32) == JF.pack_factor(32 * 32) == k
    cfg = dict(resolution=56, layers=6)
    ts = TC.convert(tm, tmat, *tm.bbox(), TC.ConversionConfig(**cfg))
    js = JC.convert(jm, jmat, *jm.bbox(), JC.ConversionConfig(**cfg))
    assert int(ts.count()) > 1000
    _compare_splats(ts, js)


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
