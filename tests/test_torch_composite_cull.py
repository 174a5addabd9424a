"""The cull of the redesigned composite kernels K3/K4 and K4's segmented
walk, on the CPU: the plain mirror of the cull (render/composite.py
cull_plain) against the coverage of _chunk_planes on random and adversarial
pairs, the segment table, the state pass's plain version against the
sequential walk, the segmented plain backward against the JAX composite's
VJP (its Pallas backward in interpret mode), and the plain forward's
per-tile ``walked`` count."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mesh2splat_tpu.ops.projection import project_splats as j_project
from mesh2splat_tpu.render import binning as JB
from mesh2splat_tpu.render import composite as JCOMP
from mesh2splat_tpu.types import SplatFormat as JSF
from mesh2splat_tpu.types import Splats as JSplats
from mesh2splat_tpu.types import make_camera as j_camera

from mesh2splat_torch import kernels, state
from mesh2splat_torch.ops.projection import project_splats as t_project
from mesh2splat_torch.render import binning as TB
from mesh2splat_torch.render import composite as TCOMP


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small torch ops: one thread each keeps them from contending
    with the suite's other workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pairs(cx, cy, ca, cb, cc):
    """Planes of pairs given tile-local centres (cx, cy) (pixel units, y
    down) and conics: c_u, c_v triples of (n,) f32 tensors. With the tile
    origin at 0, a pair's centre in the tile is (mean_x, -mean_y)."""
    t = {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in dict(
        mean_x=cx, mean_y=-np.asarray(cy, np.float32), conic_a=ca,
        conic_b=cb, conic_c=cc).items()}
    zero = torch.zeros(())
    _, c_u, c_v, _, _ = TCOMP._planes(lambda name: t[name], zero, zero)
    return c_u, c_v


def _covered_blocks(c_u, c_v):
    """(n, NUM_BLOCKS) bool: the cull blocks in which _chunk_planes' test
    marks at least one pixel of each pair as inside its quad."""
    x, y, _, _, _ = TCOMP._pixel_coords("cpu")
    inside = TCOMP._quad_inside(tuple(c[:, None] for c in c_u),
                                tuple(c[:, None] for c in c_v), x, y)
    # row-major pixels (by, row, bx, col) -> cull block by * 4 + bx
    return (inside.reshape(-1, 8, TCOMP.BLOCK_H, 4, TCOMP.BLOCK_W)
            .any(dim=4).any(dim=2).reshape(-1, TCOMP.NUM_BLOCKS))


def _conic(sx, sy, theta):
    """The conic (inverse covariance) of std devs sx, sy rotated by theta."""
    c, s = np.cos(theta), np.sin(theta)
    inv = np.stack([1 / sx**2, 1 / sy**2])
    ca = c * c * inv[0] + s * s * inv[1]
    cb = c * s * (inv[0] - inv[1])
    cc = s * s * inv[0] + c * c * inv[1]
    return ca, cb, cc


def _assert_conservative(c_u, c_v):
    culled = TCOMP.cull_plain(c_u, c_v)
    bad = culled & _covered_blocks(c_u, c_v)
    assert not bool(bad.any()), torch.nonzero(bad)[:5]
    return culled


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cull_never_drops_a_covered_block_random(seed):
    """Random pairs, from sub-pixel to larger than the tile, centred in and
    around it, at every orientation."""
    rng = np.random.default_rng(seed)
    n = 4000
    cx, cy = rng.uniform(-24, 56, (2, n))
    sx, sy = np.exp(rng.uniform(np.log(0.1), np.log(40), (2, n)))
    ca, cb, cc = _conic(sx, sy, rng.uniform(0, np.pi, n))
    culled = _assert_conservative(*_pairs(cx, cy, ca, cb, cc))
    assert 0.2 < float(culled.float().mean()) < 1.0


def test_cull_never_drops_a_covered_block_adversarial():
    """Degenerate conics (which cover every pixel), elongated quads whose
    mean lies outside the tile, and quad edges on pixel centres and block
    boundaries, a few ulps either side."""
    rng = np.random.default_rng(7)
    # degenerate: zero conic, det 0, det below 1e-30
    deg = np.array([[0, 0, 0], [1, 1, 1], [1e-20, 0, 1e-20], [4, 2, 1],
                    [1, -1, 1]], np.float32)
    c_u, c_v = _pairs(rng.uniform(0, 32, 5), rng.uniform(0, 32, 5),
                      *deg.T)
    culled = _assert_conservative(c_u, c_v)
    assert not bool(culled.any())   # a degenerate pair covers every block
    assert bool(_covered_blocks(c_u, c_v).all())

    # long thin quads with their mean off the tile, pointing across it
    n = 3000
    side = rng.integers(0, 4, n)
    off = rng.uniform(8, 60, n)
    cx = np.where(side == 0, -off, np.where(side == 1, 32 + off,
                  rng.uniform(0, 32, n)))
    cy = np.where(side == 2, -off, np.where(side == 3, 32 + off,
                  rng.uniform(0, 32, n)))
    theta = np.arctan2(16 - cy, 16 - cx) + rng.normal(0, 0.3, n)
    ca, cb, cc = _conic(rng.uniform(5, 30, n), rng.uniform(0.2, 2, n), theta)
    culled = _assert_conservative(*_pairs(cx, cy, ca, cb, cc))
    assert bool(culled.any()) and not bool(culled.all())

    # axis-aligned quads whose edge 3 sigma from the centre sits on a pixel
    # centre next to a block boundary or on the boundary itself, nudged by
    # a few ulps of sigma
    n = 6000
    horizontal = rng.random(n) < 0.5
    bound = np.where(horizontal, 8 * rng.integers(1, 4, n),
                     4 * rng.integers(1, 8, n)).astype(np.float64)
    edge = bound + rng.choice([-0.5, 0.0, 0.5], n)
    centre = edge - rng.uniform(0.7, 12, n) * rng.choice([-1, 1], n)
    sigma = np.abs(edge - centre) / 3.0
    sigma = np.float32(sigma) * (1 + rng.integers(-4, 5, n) * 2.0**-23)
    other = rng.uniform(0, 32, n)
    thin = rng.uniform(0.3, 3, n)
    cx = np.where(horizontal, centre, other)
    cy = np.where(horizontal, other, centre)
    sx = np.where(horizontal, sigma, thin)
    sy = np.where(horizontal, thin, sigma)
    ca, cb, cc = _conic(sx, sy, np.zeros(n))
    c_u, c_v = _pairs(cx, cy, ca, cb, cc)
    culled = _assert_conservative(c_u, c_v)
    # the edge pixel itself is covered in some of them, next to a block
    # the cull drops
    cov = _covered_blocks(c_u, c_v)
    assert bool((cov & ~culled).any()) and bool(culled.any())


def _tiny_scene(seed=3, n=1500, w=128, h=64):
    """Small splats projected and binned (the "full" variant), as numpy
    fields of the JAX package's shape."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    sp = dict(pos=rng.uniform(-1, 1, (n, 3)).astype(np.float32),
              color=rng.uniform(0.05, 1, (n, 4)).astype(np.float32),
              scale=rng.uniform(0.002, 0.012, (n, 3)).astype(np.float32),
              normal=rng.normal(size=(n, 3)).astype(np.float32),
              quat=q / np.linalg.norm(q, axis=-1, keepdims=True),
              pbr=rng.uniform(0, 1, (n, 2)).astype(np.float32),
              valid=np.ones(n, bool))
    cam = dict(eye=[0, 0, 3], center=[0, 0, 0], up=[0, 1, 0],
               fov_y_rad=1.0, width=w, height=h)
    proj = t_project(state.splats(sp, "cpu"), state.camera(j_camera(**cam),
                                                           "cpu"))
    return TB.bin_pairs(proj, w, h, variant="full"), w, h


def test_cull_is_not_vacuous_on_tiny_splats():
    """On a scene of splats a few pixels wide the rule drops at least half
    of the (pair, cull block) of every chunk of every tile, and never one
    that _chunk_planes covers."""
    b, w, h = _tiny_scene()
    ty, tx = TB.tiles_for(w, h)
    idx = TB.field_index("full")
    starts, ends, aligned, nc = TCOMP._tile_ranges(b.tile_starts)
    tiles = torch.arange(ty * tx)
    tjf, py0 = TCOMP._tile_origin(tiles, tx, h)
    lane = torch.arange(TCOMP.CHUNK)
    culled_n = total = 0
    for c in range(int(nc.max())):
        rows = aligned[:, None] + c * TCOMP.CHUNK + lane
        live = (rows >= starts[:, None]) & (rows < ends[:, None])
        st = b.fields[:, rows.clamp(max=b.fields.shape[1] - 1)]
        _, c_u, c_v, _, _ = TCOMP._planes(lambda n: st[idx[n]], tjf[:, :, 0],
                                           py0[:, :, 0])
        c_u, c_v = [c[live] for c in c_u], [c[live] for c in c_v]
        culled = _assert_conservative(c_u, c_v)
        culled_n += int(culled.sum())
        total += culled.numel()
    assert total > 1000
    assert culled_n >= 0.5 * total, culled_n / total


def test_segment_table():
    """Segments of seg_chunks chunks per tile, counted before each tile;
    the launch bound from shapes covers them."""
    starts = torch.tensor([0, 0, 5, 5, 300, 1100, 1100, 3000],
                          dtype=torch.int32)
    # chunks per tile: 0, 1, 0, 3 (aligned 0..300), 7 (256..1100), 0,
    # 16 (1024..3000)
    for s, want in ((1, [0, 0, 1, 1, 4, 11, 11, 27]),
                    (4, [0, 0, 1, 1, 2, 4, 4, 8]),
                    (100, [0, 0, 1, 1, 2, 3, 3, 4])):
        got = kernels.segment_table(starts, s)
        assert got.dtype == torch.int32 and got.tolist() == want, (s, got)
        assert kernels.segment_blocks(7, 3072, s) >= want[-1]


def _multi_chunk_fields(seed=11, n=700, w=64, h=64):
    """JAX-binned pairs whose tiles hold several chunks each."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    sp = dict(pos=rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32),
              color=(rng.uniform(0.05, 1, (n, 4))
                     * np.array([1, 1, 1, 0.5])).astype(np.float32),
              scale=rng.uniform(0.05, 0.4, (n, 3)).astype(np.float32),
              normal=rng.normal(size=(n, 3)).astype(np.float32),
              quat=q / np.linalg.norm(q, axis=-1, keepdims=True),
              pbr=rng.uniform(0, 1, (n, 2)).astype(np.float32),
              valid=np.ones(n, bool))
    cam = j_camera(eye=[0, 0, 5], center=[0, 0, 0], up=[0, 1, 0],
                   fov_y_rad=np.pi / 3, width=w, height=h)
    proj = j_project(JSplats(**{k: jnp.asarray(v) for k, v in sp.items()}),
                     cam, std_dev=1.0, splat_format=JSF.PLY_3DGS,
                     has_pbr=True)
    return proj, w, h


@pytest.mark.parametrize("albedo_only", [True, False])
def test_segment_states_match_the_sequential_walk(albedo_only):
    """The fold of the state pass's per-segment (T, Bpref) over segments
    0..k-1 is the sequential walk's (T, Bpref) at chunk k * seg_chunks: the
    state of a single segment of k * seg_chunks chunks."""
    proj, w, h = _multi_chunk_fields()
    variant = "albedo" if albedo_only else "full"
    b = JB.bin_pairs(proj, w, h, 0, variant=variant)
    ty, tx = JB.tiles_for(w, h)
    fields = torch.from_numpy(np.array(b.fields))
    starts = torch.from_numpy(np.array(b.tile_starts))
    ct = torch.from_numpy(np.random.default_rng(2).normal(
        size=(16, ty * 32, tx * 32)).astype(np.float32))
    nc = TCOMP._tile_ranges(starts)[3]
    assert int(nc.max()) >= 3
    s = 1
    st, last = TCOMP.segment_states_plain(fields, starts, ct, h, ty, tx,
                                          albedo_only, s)
    first = kernels.segment_table(starts, s).long()
    checked = 0
    for k in (1, 2):
        seq, _ = TCOMP.segment_states_plain(fields, starts, ct, h, ty, tx,
                                            albedo_only, k * s)
        seq_first = kernels.segment_table(starts, k * s).long()
        for t in torch.nonzero(nc > k * s)[:, 0].tolist():
            t_a = torch.ones(st.shape[1] // 2, 1024)
            bp = torch.zeros_like(t_a)
            for j in range(k):
                sv = st[first[t] + j]
                assert not bool(last[first[t] + j])
                bp = bp + t_a * sv[1::2]
                t_a = t_a * sv[0::2]
            ref = seq[seq_first[t]]
            torch.testing.assert_close(t_a, ref[0::2], rtol=1e-5, atol=1e-7)
            torch.testing.assert_close(bp, ref[1::2], rtol=1e-5, atol=1e-5)
            checked += 1
    assert checked >= 2


@pytest.mark.parametrize("albedo_only", [True, False])
def test_segmented_backward_plain_matches_jax(albedo_only):
    """The segmented plain K4 (one chunk per segment, so a segment boundary
    falls inside every multi-chunk tile) against the VJP of the JAX
    composite in interpret mode, each row within 1e-3 of its largest
    magnitude, as tests/test_torch_backward.py holds the sequential one;
    and against the sequential plain version."""
    proj, w, h = _multi_chunk_fields()
    variant = "albedo" if albedo_only else "full"
    b = JB.bin_pairs(proj, w, h, 0, variant=variant)
    ty, tx = JB.tiles_for(w, h)
    ct = np.random.default_rng(5).normal(
        size=(16, ty * 32, tx * 32)).astype(np.float32)
    _, vjp = jax.vjp(
        lambda f: JCOMP.composite_tiles(f, b.tile_starts,
                                        jnp.asarray([h], jnp.int32), ty, tx,
                                        True, albedo_only), b.fields)
    (ref,) = vjp(jnp.asarray(ct))
    ref = np.asarray(ref)
    fields = torch.from_numpy(np.array(b.fields))
    starts = torch.from_numpy(np.array(b.tile_starts))
    assert int(TCOMP._tile_ranges(starts)[3].max()) >= 3
    out = TCOMP.composite_plain(fields, starts, h, ty, tx, albedo_only)
    ct_t = torch.from_numpy(ct)
    got = TCOMP.composite_backward_plain(fields, starts, out, ct_t, h, ty, tx,
                                         albedo_only, seg_chunks=1).numpy()
    seq = TCOMP.composite_backward_plain(fields, starts, out, ct_t, h, ty, tx,
                                         albedo_only).numpy()
    nf = len(TB.VARIANT_FIELDS[variant])
    assert not got[nf:].any() and not got[:, int(b.num_pairs):].any()
    for want in (ref, seq):
        scale = np.abs(want[:nf]).max(axis=1)
        diff = np.abs(got[:nf] - want[:nf]).max(axis=1)
        assert (diff <= 1e-3 * np.maximum(scale, 1e-30)).all(), diff / scale


def test_composite_plain_walked():
    """walked: each tile's range up to the end of its last walked chunk. A
    dense opaque stack ends some tiles early; thin ones walk everything."""
    proj, w, h = _multi_chunk_fields()
    b = JB.bin_pairs(proj, w, h, 0, variant="albedo")
    ty, tx = JB.tiles_for(w, h)
    fields = torch.from_numpy(np.array(b.fields))
    starts = torch.from_numpy(np.array(b.tile_starts))
    img, walked = TCOMP.composite_plain(fields, starts, h, ty, tx, True,
                                        return_walked=True)
    assert torch.equal(img, TCOMP.composite_plain(fields, starts, h, ty, tx,
                                                  True))
    assert torch.equal(walked, (starts[1:] - starts[:-1]).int())

    dense = JB.bin_pairs(dataclasses.replace(
        proj, color=proj.color.at[:, 3].set(1.0), conic=proj.conic * 0.05),
        w, h, 0, variant="albedo")
    fields = torch.from_numpy(np.array(dense.fields))
    starts = torch.from_numpy(np.array(dense.tile_starts))
    img, walked = TCOMP.composite_plain(fields, starts, h, ty, tx, True,
                                        return_walked=True)
    n = (starts[1:] - starts[:-1]).int()
    assert bool((walked <= n).all()) and bool((walked < n).any())
    ended = walked < n
    assert float(img[14].reshape(ty, 32, tx, 32).permute(0, 2, 1, 3)
                 .reshape(ty * tx, -1)[ended].max()) <= TCOMP.MIN_T
