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
from mesh2splat_torch.render import binning as TB
from mesh2splat_torch.render import composite as TCOMP
from mesh2splat_torch.types import make_camera
from torch_parity import sphere_mesh

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _slot_inputs(device, atlas="bf16"):
    mesh, mat = sphere_mesh(800, seed=1, tex=64)
    tm, tmat = state.mesh(mesh, device), state.material(mat, device)
    seen = {}
    real = TF.fragment_apply

    def spy(records, tapsT, metaT, *args, **kw):
        seen.update(records=records, tapsT=tapsT, metaT=metaT, args=args)
        return real(records, tapsT, metaT, *args, **kw)

    TF.fragment_apply = spy
    try:
        TC.convert(tm, tmat, *tm.bbox(), TC.ConversionConfig(96, 6),
                   atlas=TC.pack_atlas(tmat, precision=atlas))
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


def _adversarial_pairs(device, albedo_only, seed=0):
    """Binned pairs built by hand for a 200x70 image (its height no
    multiple of 32): every tile holds tiny splats (the mostly culled case),
    a degenerate pair (zero conic: it covers every pixel) and axis-aligned
    quads whose edge sits on a pixel centre at a cull-block boundary; tile
    LONG_TILE holds 45 chunks, with tiny splats, then an opaque stack that
    covers the whole tile from pair 2100 on, then more pairs that the early
    exit skips."""
    rng = np.random.default_rng(seed)
    ty, tx = TB.tiles_for(W_ADV, H_ADV)
    nf = 9 if albedo_only else 18
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
        f[5:8] = rng.uniform(0.05, 1, (3, n))
        f[8] = alpha
        if not albedo_only:
            f[9:] = rng.uniform(-1, 1, (9, n))
        cols.append(f)
        counts.append(n)
    fields = np.concatenate(cols, 1)
    p = -(-fields.shape[1] // 128) * 128 + 128
    full = np.zeros((16 if albedo_only else 24, p), np.float32)
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
    fields, starts, ty, tx = _adversarial_pairs(cuda, albedo_only)
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
    fields, starts, ty, tx = _adversarial_pairs(cuda, albedo_only)
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
    """K3 and K4 stage whole chunks of 128 pairs in 16-byte copies: a pair
    axis that is not a multiple of 128 (of 4, or not even that) raises
    ValueError in every wrapper, and nothing is launched."""
    fields, starts, ty, tx = _adversarial_pairs(cuda, True)
    narrow = fields[:, :fields.shape[1] - cut].contiguous()
    kw = dict(height=H_ADV, ty=ty, tx=tx, albedo_only=True)
    ct = torch.zeros((16, ty * 32, tx * 32), device=cuda)
    res = torch.zeros((2, ty * 32, tx * 32), device=cuda)
    before = dict(kernels.launches)
    for call in (lambda: kernels.composite_forward(narrow, starts, **kw),
                 lambda: kernels.composite_bwd_states(narrow, starts, ct,
                                                      **kw),
                 lambda: kernels.composite_backward(narrow, starts, ct, res,
                                                    **kw)):
        with pytest.raises(ValueError, match="multiple of 128"):
            call()
    assert kernels.launches == before
    torch.cuda.synchronize()


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
