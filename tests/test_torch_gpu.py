"""mesh2splat_torch's CUDA kernels against their plain PyTorch versions on
the card, and the slice (conversion, a training step, a shadowed FINAL
frame, an OVERDRAW frame) on the card against the same code on the CPU.
Marked ``gpu``: each test asks the ``cuda`` fixture for the card and skips
where there is none (run them with ``python -m pytest tests -m gpu`` on a
machine with an H100)."""

import numpy as np
import pytest
import torch

from mesh2splat_torch import kernels, state
from mesh2splat_torch.ops import conversion as TC
from mesh2splat_torch.ops import fragment as TF
from mesh2splat_torch.ops import segments as TS
from mesh2splat_torch.render import binning as TB
from mesh2splat_torch.render import composite as TCOMP
from mesh2splat_torch.types import Material as TMaterial
from mesh2splat_torch.types import make_camera
from torch_parity import (SLOT_CASES, SLOT_GEOM, adversarial_slots,
                          gathered_taps, slot_records, sphere_mesh)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _slot_inputs(device, atlas="bf16"):
    """What a textured conversion hands K2 (atlas: a PackedAtlas's
    precision, None for the conversion's own f32 atlas)."""
    mesh, mat = sphere_mesh(800, seed=1, tex=64)
    tm, tmat = state.mesh(mesh, device), state.material(mat, device)
    seen = {}
    real = TF.fragment_apply

    def spy(records, tapsT, metaT, *args, **kw):
        seen.update(records=records, tapsT=gathered_taps(tapsT, kw),
                    atlasT=tapsT, rows=kw.get("rows"), metaT=metaT,
                    args=args)
        return real(records, tapsT, metaT, *args, **kw)

    TF.fragment_apply = spy
    try:
        TC.convert(tm, tmat, *tm.bbox(), TC.ConversionConfig(96, 6),
                   atlas=TC.pack_atlas(tmat, precision=atlas)
                   if atlas else None)
    finally:
        TF.fragment_apply = real
    return seen


def _on_cpu(*ts):
    return [t.cpu() for t in ts]


@pytest.mark.parametrize("atlas", ["bf16", "f32"])
def test_kernels_k1_k2_match_plain(cuda, atlas):
    s = _slot_inputs(cuda, atlas)
    res, geom, k, hb, hn, hm, packed = s["args"]
    rec, taps, meta = s["records"], s["tapsT"], s["metaT"]
    rows = kernels.texel_rows(rec, meta, res=res, geom=geom, k=k,
                              n_rows=1 << 20)
    plain = TF.texel_rows(*_on_cpu(rec, meta), res=res, geom=geom, k=k,
                          n_rows=1 << 20)
    assert torch.equal(rows.cpu(), plain)
    out = kernels.fragment_apply(rec, taps, meta, res=res, geom=geom, k=k,
                                 has_base=hb, has_normal=hn, has_mr=hm,
                                 taps_packed=packed)
    ref, _ = TF.fragment_apply(*_on_cpu(rec, taps, meta), res, geom, k, hb,
                               hn, hm, packed)
    out = out.cpu()
    assert torch.equal(out[19], ref[19])
    live = ref[19] > 0
    assert float((out[:19, live] - ref[:19, live]).abs().max()) <= 2e-5


def _k1_both(cuda, meta, res=64, seed=4):
    """K1 and its plain version on clones of the same CUDA meta table:
    (rows, metaT after the kernel, plain rows, metaT after the plain)."""
    rec = torch.from_numpy(slot_records(int(meta[0].max()) + 1, res,
                                        seed=seed)).to(cuda)
    kw = dict(res=res, geom=SLOT_GEOM, k=4, n_rows=1 << 20)
    m_k = torch.from_numpy(meta).to(cuda)
    m_p = m_k.clone()
    rows = kernels.texel_rows(rec, m_k, **kw)
    plain = TF.texel_rows_plain(rec, m_p, **kw)
    return rows, m_k, plain, m_p, lambda m: kernels.texel_rows(rec, m, **kw)


# 10,007 and 3,001 slots are no multiple of 4 (scalar loads); 12,288 is a
# whole number of blocks; 3,000,000 puts a segment of a million slots and
# a two-million-slot tail behind the blocks that search it
@pytest.mark.parametrize("case,cap", [
    (case, cap) for case in SLOT_CASES for cap in (3001, 10007, 12288)]
    + [("single", 3_000_000)])
def test_kernel_k1_adversarial(cuda, case, cap):
    """K1 on hand-built slot tables (blocks that start inside a segment,
    segments over several blocks, triangle spans far beyond a block's,
    zero-width producers, slots past the total) with row 2 zero: rows and
    local equal to the plain version's, the rows on a second run bit-equal,
    and local equal to the slot fill's (segments.expand_monotone)."""
    offsets, widths, meta = adversarial_slots(case, cap, seed=cap)
    rows, m_k, plain, m_p, again = _k1_both(cuda, meta)
    assert torch.equal(rows, plain)
    assert torch.equal(m_k, m_p)
    fill, _ = TS.expand_monotone(torch.from_numpy(offsets).to(cuda),
                                 torch.from_numpy(widths).to(cuda), cap)
    assert torch.equal(m_k[2], fill.float())
    m2 = torch.from_numpy(meta).to(cuda)
    assert torch.equal(again(m2), rows) and torch.equal(m2, m_k)
    torch.cuda.synchronize()


def test_texel_rows_wrapper_rejects(cuda):
    """K1 takes float32 CUDA tensors of 64 record rows and 4 meta rows,
    contiguous, on one device, and a power of two k: anything else raises
    ValueError and launches nothing."""
    _, _, meta = adversarial_slots("mixed", 3001, seed=1)
    rec = torch.from_numpy(slot_records(int(meta[0].max()) + 1, 64)).to(cuda)
    m = torch.from_numpy(meta).to(cuda)
    kw = dict(res=64, geom=SLOT_GEOM, k=4, n_rows=1 << 20)
    before = dict(kernels.launches)
    for r, mt, what in ((rec.cpu(), m, "CUDA tensor"),
                        (rec, m.cpu(), "CUDA tensor"),
                        (rec, m.double(), "dtype"),
                        (rec, m[:3].contiguous(), "shape"),
                        (rec[:60].contiguous(), m, "shape"),
                        (rec, m.t().contiguous().t(), "contiguous")):
        with pytest.raises(ValueError, match=what):
            kernels.texel_rows(r, mt, **kw)
    for k in (0, 3, 6):
        with pytest.raises(ValueError, match="power of two"):
            kernels.texel_rows(rec, m, **{**kw, "k": k})
    assert kernels.launches == before
    torch.cuda.synchronize()


def _bits_equal(a, b):
    """Equal bit for bit, any NaN equal to any NaN."""
    return bool(((a.view(torch.int32) == b.view(torch.int32))
                 | (a.isnan() & b.isnan())).all())


def _k2_local_runs(rec, taps, meta, kw):
    """K2 in local mode, its plain version and K2 again, each on its own
    CUDA copy of meta (row 2 zero): [(out, meta after), ...]."""
    runs = []
    for fn in (kernels.fragment_apply, TF.fragment_apply_plain,
               kernels.fragment_apply):
        m = meta.clone()
        m[2] = 0
        runs.append((fn(rec, taps, m, **kw, local_in_kernel=True), m))
    return runs


# 3,001 slots end inside a warp; 3,000,000 put a segment of a million slots
# behind the warps that search it
@pytest.mark.parametrize("case,cap", [
    (case, cap) for case in SLOT_CASES for cap in (3001, 12288)]
    + [("single", 3_000_000)])
def test_kernel_k2_local_adversarial(cuda, case, cap):
    """K2 in local mode on hand-built slot tables with row 2 zero: its 20
    output rows and the local it writes bit-equal to the plain version's
    and to a second run's, and local equal to the slot fill's
    (segments.expand_monotone)."""
    offsets, widths, meta = adversarial_slots(case, cap, seed=cap)
    rec = torch.from_numpy(slot_records(int(meta[0].max()) + 1, 4096, seed=6,
                                        attrs=True)).to(cuda)
    kw = dict(res=4096, geom=((0, 1, 1, 1),), k=1, has_base=False,
              has_normal=False, has_mr=False, taps_packed=False)
    (out_k, m_k), (out_p, m_p), (out_2, m_2) = _k2_local_runs(
        rec, torch.zeros((1, cap), device=cuda),
        torch.from_numpy(meta).to(cuda), kw)
    assert _bits_equal(out_k, out_p) and _bits_equal(out_2, out_k)
    assert torch.equal(m_k, m_p) and torch.equal(m_2, m_k)
    fill, _ = TS.expand_monotone(torch.from_numpy(offsets).to(cuda),
                                 torch.from_numpy(widths).to(cuda), cap)
    assert torch.equal(m_k[2], fill.float())
    assert int((out_k[19] > 0).sum()) >= min(1000, cap // 3)   # covered
    torch.cuda.synchronize()


@pytest.mark.parametrize("textured", [False, True])
def test_kernel_k2_local_matches_plain(cuda, textured):
    """K2 in local mode on what a sphere's conversion hands K2 (untextured:
    the conversion's own call; textured: K2 given K1's inputs, which the
    conversion does not do but the kernel allows): bit-equal to its plain
    version and to a second run, and local equal to K1's."""
    mesh, mat = sphere_mesh(800, seed=1, tex=64)
    tm, tmat = state.mesh(mesh, cuda), state.material(mat, cuda)
    if not textured:
        tmat = TMaterial.default(cuda)
    seen = {}
    real = TF.fragment_apply

    def spy(records, tapsT, metaT, *args, **kw):
        seen.update(records=records, tapsT=gathered_taps(tapsT, kw),
                    metaT=metaT.clone(), args=args, **kw)
        return real(records, tapsT, metaT, *args, **kw)

    TF.fragment_apply = spy
    try:
        before = dict(kernels.launches)
        TC.convert(tm, tmat, *tm.bbox(), TC.ConversionConfig(128, 6))
        ran = {n: kernels.launches[n] - before[n] for n in before}
    finally:
        TF.fragment_apply = real
    res, geom, k, hb, hn, hm, packed = seen["args"]
    assert seen["local_in_kernel"] is not textured
    assert ran["texel_rows"] == int(textured)
    assert ran["fragment_apply_local"] == int(not textured)
    kw = dict(res=res, geom=geom, k=k, has_base=hb, has_normal=hn,
              has_mr=hm, taps_packed=packed)
    meta = seen["metaT"]
    (out_k, m_k), (out_p, m_p), (out_2, m_2) = _k2_local_runs(
        seen["records"], seen["tapsT"], meta, kw)
    if textured:   # K1 wrote local before K2 ran
        assert torch.equal(m_k[2], meta[2])
    else:
        m1 = meta.clone()
        kernels.texel_rows(seen["records"], m1, res=res, geom=SLOT_GEOM, k=4,
                           n_rows=1 << 20)
        assert torch.equal(m_k[2], m1[2])
    assert torch.equal(m_k, m_p) and torch.equal(m_2, m_k)
    assert _bits_equal(out_k, out_p) and _bits_equal(out_2, out_k)
    assert int((out_k[19] > 0).sum()) > 10000
    torch.cuda.synchronize()


def _k2_rows_runs(rec, atlas, meta, rows, kw):
    """K2 reading atlas (f32 or packed, field-major) by rows, in both
    layouts the kernel reads, against its plain version (index_select, then
    the plain math): True where every run is bit-equal to the plain output,
    a second run and the rows-less kernel on the gathered taps included."""
    ref = TF.fragment_apply_plain(rec, atlas, meta.clone(), rows=rows, **kw)
    gathered = atlas.index_select(1, rows)
    runs = [kernels.fragment_apply(rec, gathered, meta.clone(), **kw)]
    for a in (atlas, atlas.T.contiguous().T):   # field-major, row-major
        runs += [kernels.fragment_apply(rec, a, meta.clone(), rows=rows,
                                        **kw) for _ in range(2)]
    torch.cuda.synchronize()
    return all(_bits_equal(r, ref) for r in runs), ref


@pytest.mark.parametrize("atlas,k", [("stack", 1), ("stack", 2), ("f32", 4),
                                     ("bf16", 1), ("bf16", 2), ("bf16", 4)])
def test_kernel_k2_rows_matches_plain(cuda, atlas, k, monkeypatch):
    """K2 as the conversion calls it (the tap atlas and K1's rows; "stack":
    the conversion's own f32 atlas, else a prebuilt PackedAtlas), k texels
    an atlas row (through pack_factor's FAST_ROWS), and on the same atlas
    with adversarial rows (every slot on column 0, every slot on the last
    column, random columns): bit-equal to the plain version, to a second
    run, to the rows-less kernel on the gathered taps, in both atlas
    layouts. The slots use sub-texel groups 0 and k - 1 (for packed k = 2,
    the high and the low halves of the words)."""
    monkeypatch.setattr(TF, "FAST_ROWS", {1: TF.FAST_ROWS, 2: 3000,
                                          4: 1500}[k])
    s = _slot_inputs(cuda, None if atlas == "stack" else atlas)
    res, geom, kk, hb, hn, hm, packed = s["args"]
    assert kk == k and packed == (atlas == "bf16")
    rec, A, meta, rows = s["records"], s["atlasT"], s["metaT"], s["rows"]
    kw = dict(res=res, geom=geom, k=k, has_base=hb, has_normal=hn,
              has_mr=hm, taps_packed=packed)
    g = TF._gather_rec(rec, meta)
    su = TF._slot_uv(g, meta, res)
    sub = TF._tap_index(su["uu"], su["vv"], g[TF.REC["mid"]],
                        g[TF.REC["lod"]], geom, k)[1]
    assert {0, k - 1} <= set(sub.unique().tolist())
    ok, ref = _k2_rows_runs(rec, A, meta, rows, kw)
    assert ok and int((ref[19] > 0).sum()) > 10000
    n = A.shape[1]
    rng = np.random.default_rng(k)
    for r in (torch.zeros_like(rows), torch.full_like(rows, n - 1),
              torch.from_numpy(rng.integers(0, n, rows.shape[0]).astype(
                  np.int32)).to(cuda)):
        assert _k2_rows_runs(rec, A, meta, r, kw)[0]


# 3,001 and 10,007 slots are no multiple of a block's slots; "unit" (one
# slot a triangle) and "sparse_tris" (ids that skip 50-500) put more
# triangles in a block than it stages
@pytest.mark.parametrize("case,cap,packed", [
    (case, cap, packed) for case in ("unit", "sparse_tris", "mixed")
    for cap in (3001, 10007) for packed in (False, True)])
def test_kernel_k2_rows_adversarial(cuda, case, cap, packed):
    """K2 with every map, reading a random k = 4 atlas by random rows, on
    hand-built slot tables: bit-equal to the plain version, to a second run
    and to the rows-less kernel on the gathered taps, in both layouts."""
    _, _, meta = adversarial_slots(case, cap, seed=cap)
    rng = np.random.default_rng(cap)
    rec = torch.from_numpy(slot_records(int(meta[0].max()) + 1, 64, seed=7,
                                        attrs=True)).to(cuda)
    rec[54:58] = rec[54:58].abs()   # colour factors
    n_cols = 1280   # SLOT_GEOM's two levels at k = 4
    taps = rng.uniform(0, 1, (160, n_cols)).astype(np.float32)
    atlas = torch.from_numpy(taps).to(cuda)
    if packed:
        hi = atlas[:80].to(torch.bfloat16).float().view(torch.int32)
        lo = atlas[80:].to(torch.bfloat16).float().view(torch.int32)
        atlas = ((hi & -65536) | ((lo >> 16) & 0xFFFF)).contiguous()
    m = torch.from_numpy(meta).to(cuda)
    kernels.texel_rows(rec, m, res=64, geom=SLOT_GEOM, k=4, n_rows=n_cols)
    rows = torch.from_numpy(rng.integers(0, n_cols, cap).astype(
        np.int32)).to(cuda)
    kw = dict(res=64, geom=SLOT_GEOM, k=4, has_base=True, has_normal=True,
              has_mr=True, taps_packed=packed)
    ok, ref = _k2_rows_runs(rec, atlas, m, rows, kw)
    assert ok and int((ref[19] > 0).sum()) >= cap // 4


def test_fragment_apply_wrapper_rejects(cuda):
    """K2 with rows takes (cap,) int32 CUDA rows and an atlas of k*40 f32
    (k*20 int32 packed) fields, field-major or row-major: anything else
    raises ValueError and launches nothing."""
    _, _, meta = adversarial_slots("mixed", 3001, seed=1)
    rec = torch.from_numpy(slot_records(int(meta[0].max()) + 1, 64,
                                        attrs=True)).to(cuda)
    m = torch.from_numpy(meta).to(cuda)
    atlas = torch.zeros((160, 1280), device=cuda)
    rows = torch.zeros(3001, dtype=torch.int32, device=cuda)
    kw = dict(res=64, geom=SLOT_GEOM, k=4, has_base=True, has_normal=True,
              has_mr=True, taps_packed=False)
    before = dict(kernels.launches)
    for a, r, extra, what in (
            (atlas, rows.long(), {}, "dtype"),
            (atlas, rows[:3000], {}, "shape"),
            (atlas, rows.cpu(), {}, "CUDA tensor"),
            (atlas[:80], rows, {}, "shape"),
            (atlas.int(), rows, {}, "dtype"),
            (atlas, rows, {"taps_packed": True}, "dtype"),
            (atlas[:, ::2], rows, {}, "contiguous"),
            (atlas, None, {}, "slots")):
        with pytest.raises(ValueError, match=what):
            kernels.fragment_apply(rec, a, m, rows=r, **{**kw, **extra})
    assert kernels.launches == before
    torch.cuda.synchronize()


def _random_splats(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return dict(pos=rng.uniform(-1, 1, (n, 3)).astype(np.float32),
                color=rng.uniform(0.05, 1, (n, 4)).astype(np.float32),
                scale=rng.uniform(0.01, 0.1, (n, 3)).astype(np.float32),
                normal=rng.normal(size=(n, 3)).astype(np.float32),
                quat=q / np.linalg.norm(q, axis=-1, keepdims=True),
                pbr=rng.uniform(0, 1, (n, 2)).astype(np.float32),
                valid=np.ones(n, bool))


def _binned(device, albedo_only):
    from mesh2splat_torch.ops.projection import project_splats

    cam = make_camera([0, 0, 3], [0, 0, 0], [0, 1, 0], 1.0, 200, 130,
                      device=device)
    proj = project_splats(state.splats(_random_splats(), device), cam)
    return TB.bin_pairs(proj, 200, 130,
                        variant="albedo" if albedo_only else "full")


@pytest.mark.parametrize("albedo_only", [False, True])
def test_kernel_k3_matches_plain(cuda, albedo_only):
    b = _binned(cuda, albedo_only)
    ty, tx = TB.tiles_for(200, 130)
    walked = torch.empty(ty * tx, dtype=torch.int32, device=cuda)
    out = kernels.composite_forward(b.fields, b.tile_starts, height=130,
                                    ty=ty, tx=tx, albedo_only=albedo_only,
                                    walked=walked)
    ref, ref_walked = TCOMP.composite_plain(b.fields, b.tile_starts, 130, ty,
                                            tx, albedo_only,
                                            return_walked=True)
    assert float((out - ref).abs().max()) <= 1e-3
    assert torch.equal(walked, ref_walked)


W_ADV, H_ADV = 200, 70   # 7 x 3 tiles; the last row of tiles is padded
LONG_TILE = 8            # tile (1, 1): 45 chunks with an opaque stack


def _adversarial_pairs(device, variant, seed=0):
    """Binned pairs of ``variant`` ("albedo", "full", or the single-channel
    "depth" and "overdraw") built by hand for a 200x70 image (its height no
    multiple of 32): every tile holds tiny splats (the mostly culled case),
    a degenerate pair (zero conic: it covers every pixel) and axis-aligned
    quads whose edge sits on a pixel centre at a cull-block boundary; tile
    LONG_TILE holds 45 chunks (several of K4's, K5's and K6's segments),
    with tiny splats, then an opaque stack that covers the whole tile from
    pair 2100 on, then more pairs that K3's early exit skips."""
    rng = np.random.default_rng(seed)
    ty, tx = TB.tiles_for(W_ADV, H_ADV)
    nf = len(TB.VARIANT_FIELDS[variant])
    cols = []
    counts = []
    for t in range(ty * tx):
        ti, tj = divmod(t, tx)
        n = 45 * 128 - 37 if t == LONG_TILE else int(rng.integers(60, 700))
        cx = rng.uniform(-3, 35, n)
        cy = rng.uniform(-3, 35, n)
        sig = rng.uniform(0.3, 2.0, (2, n))
        theta = rng.uniform(0, np.pi, n)
        alpha = rng.uniform(0.05, 0.6, n)
        k = min(n // 3, 40)   # quads with an edge on a block boundary
        horiz = rng.random(k) < 0.5
        edge = np.where(horiz, 8 * rng.integers(1, 4, k),
                        4 * rng.integers(1, 8, k)) + rng.choice([-0.5, 0.5], k)
        ctr = edge - rng.uniform(1, 6, k) * rng.choice([-1, 1], k)
        cx[:k] = np.where(horiz, ctr, cx[:k])
        cy[:k] = np.where(horiz, cy[:k], ctr)
        sig[0, :k] = np.where(horiz, np.abs(edge - ctr) / 3, 0.8)
        sig[1, :k] = np.where(horiz, 0.8, np.abs(edge - ctr) / 3)
        theta[:k] = 0.0
        if t == LONG_TILE:   # the opaque stack
            s = slice(2100, 2100 + 300)
            cx[s], cy[s] = rng.uniform(10, 22, (2, 300))
            sig[:, s] = rng.uniform(8, 12, (2, 300))
            alpha[s] = 1.0
        c, sn = np.cos(theta), np.sin(theta)
        ia, ib = 1 / sig[0] ** 2, 1 / sig[1] ** 2
        ca, cb, cc = c * c * ia + sn * sn * ib, c * sn * (ia - ib), \
            sn * sn * ia + c * c * ib
        ca[k], cb[k], cc[k] = 0.0, 0.0, 0.0   # the degenerate pair
        f = np.zeros((nf, n), np.float32)
        f[0] = tj * 32 + cx
        f[1] = (H_ADV - ti * 32) - cy
        f[2], f[3], f[4] = ca, cb, cc
        if variant == "depth":
            f[5] = rng.uniform(0.1, 10, n)
        elif nf > 5:
            f[5:8] = rng.uniform(0.05, 1, (3, n))
            f[8] = alpha
        if nf > 9:
            f[9:] = rng.uniform(-1, 1, (9, n))
        cols.append(f)
        counts.append(n)
    fields = np.concatenate(cols, 1)
    p = -(-fields.shape[1] // 128) * 128 + 128
    full = np.zeros((TB.padded_rows(variant), p), np.float32)
    full[:nf, :fields.shape[1]] = fields
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return (torch.from_numpy(full).to(device),
            torch.from_numpy(starts).to(device), ty, tx)


@pytest.mark.parametrize("albedo_only", [False, True])
def test_kernel_k3_adversarial(cuda, albedo_only):
    """K3 on hand-built pairs (tiny splats, a degenerate pair, quad edges on
    cull-block boundaries, a 45-chunk tile whose opaque stack ends it in
    the middle of its list, an image height no multiple of 32) against its
    plain version: within 1e-3, and the same pairs walked, tile for tile."""
    fields, starts, ty, tx = _adversarial_pairs(
        cuda, "albedo" if albedo_only else "full")
    walked = torch.empty(ty * tx, dtype=torch.int32, device=cuda)
    out = kernels.composite_forward(fields, starts, height=H_ADV, ty=ty,
                                    tx=tx, albedo_only=albedo_only,
                                    walked=walked)
    ref, ref_walked = TCOMP.composite_plain(fields, starts, H_ADV, ty, tx,
                                            albedo_only, return_walked=True)
    assert float((out - ref).abs().max()) <= 1e-3
    assert torch.equal(walked, ref_walked)
    n = int(starts[LONG_TILE + 1] - starts[LONG_TILE])
    assert 2100 < int(walked[LONG_TILE]) < n


@pytest.mark.parametrize("albedo_only", [False, True])
def test_kernel_k4_adversarial(cuda, albedo_only):
    """K4 on the same pairs against its plain version for a random
    cotangent: each field row within 1e-3 of its largest magnitude, padding
    rows and rows past the last pair zero, the same bits on 8 more runs;
    segment boundaries fall inside the 45-chunk tile; the state pass's rows
    against its plain version."""
    fields, starts, ty, tx = _adversarial_pairs(
        cuda, "albedo" if albedo_only else "full")
    kw = dict(height=H_ADV, ty=ty, tx=tx, albedo_only=albedo_only)
    out = kernels.composite_forward(fields, starts, **kw)
    ct = torch.from_numpy(np.random.default_rng(1).normal(
        size=tuple(out.shape)).astype(np.float32)).to(cuda)
    res = TCOMP.backward_totals(out, ct).contiguous()
    ref = TCOMP.composite_backward_plain(fields, starts, out, ct, H_ADV, ty,
                                         tx, albedo_only)
    nf = 9 if albedo_only else 18
    scale = ref[:nf].abs().amax(1)
    seg = kernels.seg_chunks()
    assert int(TCOMP._tile_ranges(starts)[3][LONG_TILE]) > 2 * seg
    got = kernels.composite_backward(fields, starts, ct, res, **kw)
    assert bool(((got - ref)[:nf].abs().amax(1) <= 1e-3 * scale).all())
    assert not got[nf:].any() and not got[:, int(starts[-1]):].any()
    for _ in range(8):
        again = kernels.composite_backward(fields, starts, ct, res, **kw)
        assert torch.equal(got, again)
    states, _ = kernels.composite_bwd_states(fields, starts, ct, **kw)
    want, last = TCOMP.segment_states_plain(fields, starts, ct, H_ADV, ty, tx,
                                            albedo_only, seg)
    keep = ~last
    torch.testing.assert_close(states[:want.shape[0]][keep], want[keep],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cut", [4, 126])
def test_composite_wrappers_reject_unpadded_pairs(cuda, cut):
    """K3-K6 stage whole chunks of 128 pairs in 16-byte copies: a pair
    axis that is not a multiple of 128 (of 4, or not even that) raises
    ValueError in every wrapper, and nothing is launched."""
    fields, starts, ty, tx = _adversarial_pairs(cuda, "albedo")
    narrow = fields[:, :fields.shape[1] - cut].contiguous()
    kw = dict(height=H_ADV, ty=ty, tx=tx, albedo_only=True)
    ct = torch.zeros((16, ty * 32, tx * 32), device=cuda)
    res = torch.zeros((2, ty * 32, tx * 32), device=cuda)
    single, starts1, _, _ = _adversarial_pairs(cuda, "depth")
    narrow1 = single[:, :single.shape[1] - cut].contiguous()
    kw1 = dict(height=H_ADV, ty=ty, tx=tx)
    before = dict(kernels.launches)
    for call in (lambda: kernels.composite_forward(narrow, starts, **kw),
                 lambda: kernels.composite_bwd_states(narrow, starts, ct,
                                                      **kw),
                 lambda: kernels.composite_backward(narrow, starts, ct, res,
                                                    **kw),
                 lambda: kernels.min_depth(narrow1, starts1, **kw1),
                 lambda: kernels.overdraw(narrow1, starts1, **kw1)):
        with pytest.raises(ValueError, match="multiple of 128"):
            call()
    assert kernels.launches == before
    torch.cuda.synchronize()


def test_single_channel_wrappers_reject_cpu_and_misaligned(cuda):
    """K5 and K6 launch only on CUDA tensors whose field rows start on a
    16-byte boundary: a CPU tensor or a view one float in raises
    ValueError, and nothing is launched."""
    fields, starts, ty, tx = _adversarial_pairs(cuda, "depth")
    kw = dict(height=H_ADV, ty=ty, tx=tx)
    shifted = torch.zeros(fields.numel() + 1, device=cuda)[1:].view(
        fields.shape)
    shifted.copy_(fields)
    before = dict(kernels.launches)
    for fn in (kernels.min_depth, kernels.overdraw):
        with pytest.raises(ValueError, match="CUDA tensor"):
            fn(fields.cpu(), starts, **kw)
        with pytest.raises(ValueError, match="16-byte boundary"):
            fn(shifted, starts, **kw)
    assert kernels.launches == before
    torch.cuda.synchronize()


@pytest.mark.parametrize("name", ["min_depth", "overdraw"])
def test_kernel_k5_k6_adversarial(cuda, name):
    """K5 and K6 on hand-built pairs (tiny splats, a degenerate pair, quad
    edges on cull-block boundaries, a 45-chunk tile that spans several
    segments, an image height no multiple of 32) against their plain
    versions: the same bits, and the same bits on 9 more runs."""
    fields, starts, ty, tx = _adversarial_pairs(
        cuda, "depth" if name == "min_depth" else "overdraw")
    seg = kernels.single_channel_seg_chunks()
    assert int(TCOMP._tile_ranges(starts)[3][LONG_TILE]) > 2 * seg
    kw = dict(height=H_ADV, ty=ty, tx=tx)
    got = getattr(kernels, name)(fields, starts, **kw)
    plain = TCOMP.min_depth_plain if name == "min_depth" else \
        TCOMP.overdraw_plain
    ref = plain(fields, starts, H_ADV, ty, tx)
    assert torch.equal(got, ref)
    assert torch.equal(ref, plain(fields, starts, H_ADV, ty, tx,
                                  seg_chunks=seg))
    if name == "overdraw":
        assert float(got.max()) >= 100
    for _ in range(9):
        assert torch.equal(got, getattr(kernels, name)(fields, starts, **kw))


def test_kernel_k5_nan_depth(cuda):
    """A NaN depth comes out NaN at the pixels its pair covers, on every
    run, and every other pixel keeps its bits."""
    fields, starts, ty, tx = _adversarial_pairs(cuda, "depth")
    kw = dict(height=H_ADV, ty=ty, tx=tx)
    n = int(starts[LONG_TILE + 1] - starts[LONG_TILE])
    # three small splats: in the first, a middle and the last chunk
    rows = int(starts[LONG_TILE]) + torch.tensor([5, 3000, n - 3])
    bad = fields.clone()
    bad[5, rows.to(cuda)] = float("nan")
    got = kernels.min_depth(bad, starts, **kw)
    ref = TCOMP.min_depth_plain(bad, starts, H_ADV, ty, tx)
    nan = torch.isnan(got)
    assert bool(nan.any()) and torch.equal(nan, torch.isnan(ref))
    assert torch.equal(got[~nan], ref[~nan])
    assert torch.equal(got[~nan], kernels.min_depth(fields, starts,
                                                    **kw)[~nan])
    for _ in range(9):
        again = kernels.min_depth(bad, starts, **kw)
        assert torch.equal(got.view(torch.int32), again.view(torch.int32))


@pytest.mark.parametrize("albedo_only", [False, True])
def test_kernel_k4_matches_plain(cuda, albedo_only):
    """K4 against its plain version for a random cotangent: each field row
    within 1e-3 of its largest magnitude (sums in another order), padding
    rows and rows past num_pairs zero, and the same bits on a second run."""
    b = _binned(cuda, albedo_only)
    ty, tx = TB.tiles_for(200, 130)
    out = kernels.composite_forward(b.fields, b.tile_starts, height=130,
                                    ty=ty, tx=tx, albedo_only=albedo_only)
    ct = torch.from_numpy(np.random.default_rng(1).normal(
        size=tuple(out.shape)).astype(np.float32)).to(cuda)
    res = TCOMP.backward_totals(out, ct).contiguous()
    kw = dict(height=130, ty=ty, tx=tx, albedo_only=albedo_only)
    got = kernels.composite_backward(b.fields, b.tile_starts, ct, res, **kw)
    ref = TCOMP.composite_backward_plain(b.fields, b.tile_starts, out, ct,
                                         130, ty, tx, albedo_only)
    nf = 9 if albedo_only else 18
    scale = ref[:nf].abs().amax(1)
    assert bool(((got - ref)[:nf].abs().amax(1) <= 1e-3 * scale).all())
    assert not got[nf:].any() and not got[:, int(b.num_pairs):].any()
    again = kernels.composite_backward(b.fields, b.tile_starts, ct, res, **kw)
    assert torch.equal(got, again)


def test_training_step_cuda_matches_cpu(cuda):
    """One l2_loss and its gradients (K3 and K4 albedo on the card, their
    plain versions on the CPU): loss within rtol 1e-5, each parameter's
    gradient within 1e-3 of its largest magnitude."""
    from mesh2splat_torch.train import fit

    sp = _random_splats(2000, seed=3)
    out = []
    for dev in (cuda, torch.device("cpu")):
        cams = [make_camera(e, [0, 0, 0], [0, 1, 0], 1.0, 200, 130,
                            device=dev) for e in ([0, 0, 3], [0.5, 0.3, 2.8])]
        params = fit.SplatParams.from_splats(state.splats(sp, dev))
        valid = torch.ones(2000, dtype=torch.bool, device=dev)
        targets = torch.full((2, 130, 200, 3), 0.25, device=dev)
        loss = fit.l2_loss(params, valid, cams, targets, 200, 130)
        loss.backward()
        out.append((float(loss.detach()),
                    {k: v.grad.cpu() for k, v in params.as_dict().items()
                     if v.grad is not None}))
    (l_c, g_c), (l_p, g_p) = out
    assert abs(l_c - l_p) <= 1e-5 * l_p
    assert set(g_c) == set(g_p) == {"pos", "color", "opacity_logit",
                                    "log_scale", "quat"}
    for k in g_p:
        assert float((g_c[k] - g_p[k]).abs().max()) <= \
            1e-3 * float(g_p[k].abs().max()), k


def test_slice_cuda_matches_cpu(cuda):
    mesh, mat = sphere_mesh(1000, seed=4, tex=64)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        tm, tmat = state.mesh(mesh, dev), state.material(mat, dev)
        cfg = TC.calibrate(tm, *tm.bbox(), TC.ConversionConfig(128, 6))
        sp = TC.convert(tm, tmat, *tm.bbox(), cfg)
        outs.append([t.cpu() for t in (sp.valid, sp.pos, sp.color)])
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1:], outs[1][1:]):
        assert float((a - b).abs().max()) <= 2e-5


@pytest.mark.parametrize("res", [96, 100])
def test_convert_odd_resolution_cuda_matches_cpu(cuda, res):
    """The conversion at a resolution whose reciprocal is inexact: the card
    (its torch row spans and K1/K2) gives the CPU's splats bit for bit
    (a division by res must stay one IEEE division on the card, where
    PyTorch would multiply by the reciprocal of a Python scalar)."""
    mesh, mat = sphere_mesh(800, seed=res, tex=64)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        tm, tmat = state.mesh(mesh, dev), state.material(mat, dev)
        cfg = TC.calibrate(tm, *tm.bbox(), TC.ConversionConfig(res, 6))
        sp = TC.convert(tm, tmat, *tm.bbox(), cfg)
        outs.append([getattr(sp, f).cpu() for f in (
            "valid", "pos", "color", "scale", "normal", "quat", "pbr")])
    assert int(outs[1][0].sum()) > 10000
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("capacity", [1 << 18, 1 << 16])
def test_owner_of_slots_cuda_matches_cpu(cuda, capacity):
    """The class-C owner search at ~1M producers, 95 % of them with a
    count of 0 (an ALBEDO frame's single-tile splats), on the card against
    the CPU and against the forward fill, on every slot; at 1 << 16 the
    counts overrun the capacity."""
    g = torch.Generator().manual_seed(capacity)
    counts = torch.randint(1, 6, (1 << 20,), generator=g, dtype=torch.int32)
    counts[torch.rand(1 << 20, generator=g) < 0.95] = 0
    off, tot = TS.alloc_slots(counts, capacity)
    ref = TS.owner_of_slots(off, counts, capacity)
    assert torch.equal(ref, torch.clamp(TS.fill_value(
        off, counts, capacity,
        torch.arange(1 << 20, dtype=torch.int32)), min=0))
    assert (int(counts.sum()) > capacity) == (capacity == 1 << 16)
    got = TS.owner_of_slots(off.to(cuda), counts.to(cuda), capacity)
    assert torch.equal(got.cpu(), ref)


def _cubemap_pairs(device):
    """The band-clamped "depth" pairs of a 128^2 tiled shadow cubemap."""
    from mesh2splat_torch.render import shadows as TS

    sp = state.splats(_random_splats(3000, seed=5), device)
    light = torch.tensor([0.3, 0.2, 2.5], device=device)
    merged, band, need = TS._shadow_prep_fused(
        sp, light, torch.tensor(10.0, device=device), 1.0, 128)
    return TB.bin_pairs(merged, 128, 6 * 128, TB.round_pow2_budget(need),
                        variant="depth", band_ty=band)


def test_kernels_k5_k6_match_plain(cuda):
    """K5 on the cubemap's tall image and K6 on a 200x130 frame against
    their plain versions on the same CUDA tensors: the same bits."""
    b = _cubemap_pairs(cuda)
    ty, tx = TB.tiles_for(128, 6 * 128)
    got = kernels.min_depth(b.fields, b.tile_starts, height=6 * 128, ty=ty,
                            tx=tx)
    ref = TCOMP.min_depth_plain(b.fields, b.tile_starts, 6 * 128, ty, tx)
    assert 0.0 < float((got < 1e37).float().mean()) < 1.0
    assert torch.equal(got, ref)

    from mesh2splat_torch.ops.projection import project_splats

    cam = make_camera([0, 0, 3], [0, 0, 0], [0, 1, 0], 1.0, 200, 130,
                      device=cuda)
    proj = project_splats(state.splats(_random_splats(), cuda), cam)
    b = TB.bin_pairs(proj, 200, 130, variant="overdraw")
    ty, tx = TB.tiles_for(200, 130)
    got = kernels.overdraw(b.fields, b.tile_starts, height=130, ty=ty, tx=tx)
    ref = TCOMP.overdraw_plain(b.fields, b.tile_starts, 130, ty, tx)
    assert float(got.max()) >= 5
    assert torch.equal(got, ref)


@pytest.mark.parametrize("mode", ["FINAL", "OVERDRAW"])
def test_frame_cuda_matches_cpu(cuda, mode):
    """A FINAL frame with shadows (a 128^2 cubemap, which "auto" renders
    tiled for more than 65,536 splats: K5 on the card) and an OVERDRAW
    frame (K6) of converted splats,
    on the card against the CPU: the cubemaps' coverage on >= 99.9 % of
    pixels and depth within 1e-5, the images within 1e-3."""
    from mesh2splat_torch.render import shadows as TS
    from mesh2splat_torch.render.pipeline import FrameConfig, render_frame
    from mesh2splat_torch.types import RenderMode

    mesh, mat = sphere_mesh(1000, seed=4, tex=64)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        tm, tmat = state.mesh(mesh, dev), state.material(mat, dev)
        cfg = TC.calibrate(tm, *tm.bbox(), TC.ConversionConfig(256, 6))
        sp = TC.convert(tm, tmat, *tm.bbox(), cfg)
        assert sp.capacity > 65536
        cam = make_camera([0.3, 0.4, 2.8], [0, 0, 0], [0, 1, 0], 1.0, 160,
                          120, device=dev)
        fc = FrameConfig(160, 120, RenderMode[mode], gaussian_std=1.0,
                         resolution_target=256, shadows=True,
                         shadow_size=128)
        faces = None
        if mode == "FINAL":   # the cubemap render_frame takes
            faces = TS.render_shadow_cubemap(
                sp, [2.0, 2.0, 2.0], 25.0, fc.std_dev, size=128,
                device=dev).faces.cpu()
        outs.append((faces, render_frame(sp, cam, fc).cpu()))
    (f_c, img_c), (f_p, img_p) = outs
    if mode == "FINAL":
        cov_c, cov_p = f_c < 1.0, f_p < 1.0
        assert float(cov_p.float().mean()) > 0.005
        assert float((cov_c == cov_p).float().mean()) >= 0.999
        both = cov_c & cov_p
        assert float((f_c - f_p)[both].abs().max()) <= 1e-5
    assert float(img_p.max()) > 0.0
    assert float((img_c - img_p).abs().max()) <= 1e-3


def _sphere_glb(path, n_tri=2000, seed=2):
    """torch_parity.sphere_mesh as a GLB (the port's writer, a vertex soup
    with a PNG base-colour texture)."""
    import io

    from PIL import Image

    from mesh2splat_torch.io import gltf

    mesh, mat = sphere_mesh(n_tri, seed=seed, tex=64)
    buf = io.BytesIO()
    Image.fromarray((mat["base_color"] * 255).astype(np.uint8)).save(
        buf, format="PNG")
    v = mesh["tri_pos"].reshape(-1, 3)
    gltf.write_glb(path, v, np.arange(len(v), dtype=np.uint32).reshape(-1, 3),
                   normals=mesh["tri_normal"].reshape(-1, 3),
                   uvs=mesh["tri_uv"].reshape(-1, 2),
                   base_color_png=buf.getvalue())


def test_native_codec_builds_on_the_card_machine(cuda):
    from mesh2splat_torch.io import native

    assert native.available()


def test_cli_convert_cuda_matches_cpu(cuda, tmp_path, capsys):
    """The CLI's convert on the card counts the CPU run's splats, with zero
    drops on both."""
    from mesh2splat_torch import cli
    from mesh2splat_torch.io import ply

    glb = tmp_path / "sphere.glb"
    _sphere_glb(glb)
    counts = []
    for d in ("cuda", "cpu"):
        out = tmp_path / f"{d}.ply"
        cli.main(["convert", str(glb), str(out), "--resolution", "128",
                  "--device", d])
        assert "dropped 0," in capsys.readouterr().out
        counts.append(ply.read_ply(out)[0]["pos"].shape[0])
    assert counts[0] == counts[1] > 1000


def test_fit_splats_one_rank_nccl(cuda, tmp_path):
    """fit_splats(devices_mesh=) over a one-rank NCCL group: the history and
    the fitted splats bit-equal to the plain fit's. Both run with
    torch.use_deterministic_algorithms: a splat over several tiles sums
    its class-C gradients with index_add_, whose atomics add in any order
    and change the last bits from one run to the next; the deterministic
    index_add_ does not (the plain fit is run twice to show it)."""
    import dataclasses

    import torch.distributed as dist

    from mesh2splat_torch.parallel import sharding
    from mesh2splat_torch.train import fit

    sp = state.splats(_random_splats(3000, seed=4), cuda)
    cams = [make_camera(e, [0, 0, 0], [0, 1, 0], np.pi / 3, 256, 192,
                        device=cuda) for e in ([0, 0, 4], [0.8, 0.4, 3.5])]
    with torch.no_grad():
        targets = torch.stack([fit.render_rgb(sp, c, 256, 192)
                               for c in cams])
    start = dataclasses.replace(sp, color=sp.color.flip(0))
    cfg = fit.FitConfig(steps=3, lr=1e-2, width=256, height=192)
    torch.use_deterministic_algorithms(True, warn_only=True)
    sharding.init_distributed(f"file://{tmp_path}/store", 1, 0)
    try:
        ref_sp, ref = fit.fit_splats(start, cams, targets, cfg)
        again_sp, again = fit.fit_splats(start, cams, targets, cfg)
        mesh = sharding.make_mesh()
        assert mesh.device_type == "cuda"
        got_sp, got = fit.fit_splats(start, cams, targets, cfg,
                                     devices_mesh=mesh)
    finally:
        dist.destroy_process_group()
        torch.use_deterministic_algorithms(False)
    assert again == ref and torch.equal(again_sp.pos, ref_sp.pos)
    assert got == ref and ref[-1] < ref[0]
    for f in ("pos", "color", "scale", "quat"):
        assert torch.equal(getattr(got_sp, f), getattr(ref_sp, f)), f


def test_demo_turntable_on_the_card(cuda, tmp_path):
    """The demo's turntable on the card: every frame written, FrameTimer's
    samples from the frames past its latency."""
    from mesh2splat_torch import demo

    timer = demo.turntable(8, tmp_path, "cuda", size=64)
    assert len(list((tmp_path / "turntable").glob("*.png"))) == 8
    assert len(timer.samples) == 3 and timer.average_ms > 0
