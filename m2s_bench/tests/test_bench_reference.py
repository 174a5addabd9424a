"""The reference agrees with the port's CPU path (its plain versions) at a
tiny size, for each entry the cells drive; the counts of the roofline
modules agree with counts made by hand."""

import dataclasses

import pytest
import torch
from conftest import ALBEDO, CONVERT, SEED, SHADOWS, tiny_config, tiny_mix

from m2s_bench import compare, counting, harness, program
from m2s_bench.assets import asset_seed, make_assets, synth_asset
from m2s_bench.entries import orbit
from m2s_bench.reference import entry as ref
from m2s_bench.reference.render import binning as RB


def _asset(config):
    return synth_asset(config["triangles"], config["texture_px"],
                       asset_seed(SEED, 0), "cpu")


def _convert_both(config):
    asset = _asset(config)
    scene = program.scene(asset)
    kw = dict(resolution=config["resolution"], layers=config["layers"],
              gaussian_std=config["gaussian_std"],
              calibrated=config["calibrated"])
    got = scene.convert(**kw)
    want, cfg = ref.convert(asset, kw["resolution"], kw["layers"],
                            kw["gaussian_std"], kw["calibrated"])
    return scene, got, want, cfg


def test_synth_asset_is_seeded():
    a = synth_asset(200, 16, 5, "cpu")
    b = synth_asset(200, 16, 5, "cpu")
    c = synth_asset(200, 16, 6, "cpu")
    assert a["tri_pos"].shape == (200, 3, 3)
    assert all(torch.equal(a[k], b[k]) for k in a if torch.is_tensor(a[k]))
    assert not torch.equal(a["base_color_tex"], c["base_color_tex"])


def test_fixed_shapes_differ_only_in_maps():
    """With fixed shapes every seed converts the same set of shapes: asset
    i's geometry is the same for any seed, its maps are the seed's."""
    cfg = {"triangles": 200, "texture_px": 16, "queue_assets": 2}
    a = make_assets(cfg, 5, "cpu", fixed_shapes=True)
    b = make_assets(cfg, 6, "cpu", fixed_shapes=True)
    for x, y in zip(a, b):
        assert torch.equal(x["tri_pos"], y["tri_pos"])
        assert not torch.equal(x["base_color_tex"], y["base_color_tex"])
    assert not torch.equal(a[0]["tri_pos"], a[1]["tri_pos"])
    seeded = make_assets(cfg, 5, "cpu")
    assert not torch.equal(a[0]["tri_pos"], seeded[0]["tri_pos"])


def test_convert_matches_the_port(spec):
    _, got, want, _ = _convert_both(tiny_config(spec, CONVERT))
    assert int(want.valid.sum()) > 100
    r = compare.splat_readings(got, want)
    assert r == {"count_diff": 0, "max_err": 0.0}


@pytest.mark.parametrize("cell", [SHADOWS, ALBEDO])
def test_frame_matches_the_port(spec, cell):
    from mesh2splat_torch.types import RenderMode

    config, mix = tiny_config(spec, cell), tiny_mix(spec, cell)
    scene, got, want, cfg = _convert_both(config)
    pose = orbit.eye(mix, 40.0, 7)
    img = scene.render(got, eye=pose, width=mix["width"],
                       height=mix["height"], fov_deg=mix["fov_deg"],
                       mode=RenderMode[mix["mode"]], shadows=mix["shadows"])
    img_ref = ref.render(want, cfg, pose, mix["width"], mix["height"],
                         mix["fov_deg"], mix["mode"], mix["shadows"])
    assert img.shape == (mix["height"], mix["width"], 3)
    assert float(img_ref.abs().max()) > 0
    assert compare.image_max_err(img, img_ref) == 0.0


def _binned(spec, variant, width=64, height=48):
    """A tiny frame's binned pairs in the reference."""
    from m2s_bench.reference.ops.projection import project_splats
    from m2s_bench.reference.types import RenderMode, make_camera

    config = tiny_config(spec, SHADOWS)
    splats, cfg = ref.convert(_asset(config), config["resolution"],
                              config["layers"], 1.0)
    cam = make_camera([0.3, 0.4, 3.2], [0, 0, 0], [0, 1, 0], 1.0, width,
                      height, device="cpu")
    proj = project_splats(splats, cam, std_dev=1.0 / cfg.resolution,
                          render_mode=RenderMode.ALBEDO)
    cap = RB.round_pow2_budget(int(RB.required_overflow(proj, width,
                                                        height)))
    binned = RB.bin_pairs(proj, width, height, cap, variant=variant)
    ty, tx = RB.tiles_for(width, height)
    return binned, height, ty, tx


@pytest.mark.parametrize("variant", ["full", "albedo", "depth"])
def test_covered_pairs_by_hand(spec, variant):
    """covered_pairs' chunked walk against a count pair by pair: each
    binned pair alone, tested at every pixel of its tile."""
    from m2s_bench.reference.render import composite as RC

    binned, height, ty, tx = _binned(spec, variant)
    fields, starts = binned.fields, binned.tile_starts
    cov, pairs = counting.covered_pairs(fields, starts, height, ty, tx,
                                        variant)
    idx = RB.field_index(variant)
    pix = RC._pixel_coords("cpu")
    hand = 0
    n = starts[1:] - starts[:-1]
    for t in range(ty * tx):
        tjf, py0 = RC._tile_origin(torch.tensor([t]), tx, height)
        for row in range(int(starts[t]), int(starts[t]) + int(n[t])):
            st = fields[:, row].reshape(-1, 1, 1)
            g, _, _ = RC._chunk_planes(lambda name: st[idx[name]][..., None],
                                       tjf, py0, pix,
                                       torch.ones(1, 1, 1, dtype=torch.bool))
            hand += int((g > 0).sum())
    assert pairs == int(starts[-1]) > 0
    assert cov == hand > 0


def test_k5_and_k3_counts_by_hand(spec):
    """K5's bytes and operations from the pair count and the covered
    (pair, pixel) count; K3's pairs walked never above the pairs."""
    from m2s_bench.reference.render import composite as RC

    mods = {m.KERNEL: m for m in harness.roofline_modules()}
    binned, height, ty, tx = _binned(spec, "depth")
    fields, starts = binned.fields, binned.tile_starts
    _, (nbytes, flops) = mods["k5"].counted(RC.min_depth_plain, fields,
                                            starts, height, ty, tx)
    pairs = int(starts[-1])
    cov, _ = counting.covered_pairs(fields, starts, height, ty, tx, "depth")
    assert nbytes == 6 * pairs * 4 + (ty * tx + 1) * 4 + ty * tx * 1024 * 4
    assert flops == 60 * pairs + 25 * cov
    binned, height, ty, tx = _binned(spec, "albedo")
    (img, (nbytes, flops)) = mods["k3"].counted(
        RC.composite_plain, binned.fields, binned.tile_starts, height, ty,
        tx, True)
    pairs = int(binned.tile_starts[-1])
    assert img.shape == (16, ty * 32, tx * 32)
    assert nbytes == 9 * pairs * 4 + (ty * tx + 1) * 4 + 16 * ty * tx * 4096
    assert 0 < flops <= 60 * pairs + 37 * pairs * 1024


def test_k2_counts_by_hand(spec):
    """K2's counts on the reference's call: 58 record fields of each
    triangle that owns a slot, the atlas groups read, 25 words a slot, and
    400 operations a slot."""
    from m2s_bench.reference.ops import fragment as RF

    mods = {m.KERNEL: m for m in harness.roofline_modules()}
    seen = []
    orig = RF.fragment_apply_plain

    def spy(*args, **kw):
        out, counts = mods["k2"].counted(orig, *args, **kw)
        seen.append((args, kw, counts))
        return out

    RF.fragment_apply_plain = spy
    try:
        _convert_both(tiny_config(spec, CONVERT))
    finally:
        RF.fragment_apply_plain = orig
    (records, atlas, meta), kw, (nbytes, flops) = seen[0]
    cap = meta.shape[1]
    tris = int(torch.unique(meta[0][meta[3] > 0]).numel())
    taps = counting.tap_bytes(records, atlas, meta, kw["rows"], kw)
    assert 0 < taps <= atlas.shape[1] * kw["k"] * 160
    assert nbytes == 58 * 4 * tris + taps + 25 * 4 * cap
    assert flops == 400 * cap


def test_k4_counts_by_hand(spec):
    """K4's counts on the reference's call: the albedo fields of every
    pair, the tile starts, 5 pixel planes read (4 cotangent channels and
    one total) and the gradient written; 100 operations a pair and 70 a
    covered (pair, pixel) over every chunk; the gradient is the plain
    version's."""
    from m2s_bench.reference.render import composite as RC

    mods = {m.KERNEL: m for m in harness.roofline_modules()}
    binned, height, ty, tx = _binned(spec, "albedo")
    fields, starts = binned.fields, binned.tile_starts
    out = RC.composite_plain(fields, starts, height, ty, tx, True)
    ct = torch.rand(out.shape, generator=torch.Generator().manual_seed(3))
    dfields, (nbytes, flops) = mods["k4"].counted(
        RC.composite_backward_plain, fields, starts, out, ct, height, ty, tx,
        True, tile_batch=7)
    pairs = int(starts[-1])
    cov, _ = counting.covered_pairs(fields, starts, height, ty, tx, "albedo")
    assert torch.equal(dfields, RC.composite_backward_plain(
        fields, starts, out, ct, height, ty, tx, True))
    assert nbytes == (9 * pairs * 4 + (ty * tx + 1) * 4
                      + 5 * ty * tx * 4096 + fields.numel() * 4)
    assert flops == 100 * pairs + 70 * cov and cov > 0


def _random_splats(n, seed, splats_cls):
    g = torch.Generator().manual_seed(seed)

    def u(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=g)

    quat = torch.randn((n, 4), generator=g)
    normal = torch.randn((n, 3), generator=g)
    return splats_cls(
        pos=u(n, 3, lo=-0.6, hi=0.6),
        color=torch.cat([u(n, 3), u(n, 1, lo=0.3, hi=0.95)], 1),
        scale=u(n, 3, lo=0.01, hi=0.06),
        normal=normal / normal.norm(dim=1, keepdim=True),
        quat=quat / quat.norm(dim=1, keepdim=True),
        pbr=u(n, 2), valid=u(n) > 0.1)


def test_fit_loss_and_gradients_match_the_port():
    """The reference's mean L2 over two views and its gradient with respect
    to every leaf against the port's ``l2_loss`` (its plain versions on the
    CPU), on seeded random splats."""
    from mesh2splat_torch.train import fit
    from mesh2splat_torch.types import Splats, make_camera

    from m2s_bench.reference import train as RT
    from m2s_bench.reference import types as RTY

    w, h = 64, 48
    eyes = ([0.0, 0.0, 3.2], [0.8, 0.4, 3.0])
    targets = torch.rand((2, h, w, 3),
                         generator=torch.Generator().manual_seed(9))
    start = _random_splats(300, 5, Splats)
    params = fit.SplatParams.from_splats(start)
    cams = [make_camera(e, [0, 0, 0], [0, 1, 0], 1.0, w, h, device="cpu")
            for e in eyes]
    cap = fit.pair_budget(start, cams, w, h)
    loss = fit.l2_loss(params, start.valid, cams, targets, w, h,
                       pair_capacity=cap)
    loss.backward()

    ref_start = _random_splats(300, 5, RTY.Splats)
    p = RT.leaves_from_splats(ref_start)
    ref_cams = [RTY.make_camera(e, [0, 0, 0], [0, 1, 0], 1.0, w, h,
                                device="cpu") for e in eyes]
    assert RB.round_pow2_budget(RT.pair_need(ref_start, ref_cams, w, h)) \
        == cap
    ref_loss = RT.l2_loss(p, ref_start.valid, ref_cams, targets, w, h, 1.0,
                          cap, tile_batch=5)
    ref_loss.backward()
    assert float(ref_loss.detach()) > 0.01
    assert float(loss.detach()) == pytest.approx(float(ref_loss.detach()),
                                                 rel=1e-6)
    for name in RT.LEAVES:
        got, want = getattr(params, name).grad, p[name].grad
        if want is None or not want.any():
            assert got is None or not got.any(), name
            continue
        assert float(want.abs().max()) > 0, name
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-6 * float(want.abs().max()))


def test_reference_adam_is_torchs():
    """The reference's Adam against ``torch.optim.Adam`` with the program's
    settings, over three steps of the same gradients."""
    from m2s_bench.reference import train as RT

    g = torch.Generator().manual_seed(1)
    a = torch.randn(50, generator=g)
    b = a.clone().requires_grad_(True)
    opt = torch.optim.Adam([b], lr=1e-2, betas=RT.ADAM_BETAS,
                           eps=RT.ADAM_EPS)
    adam = RT.Adam([a], 1e-2)
    for _ in range(3):
        grad = torch.randn(50, generator=g)
        b.grad = grad.clone()
        opt.step()
        adam.step([grad])
    torch.testing.assert_close(a, b.detach(), rtol=1e-6, atol=1e-7)
