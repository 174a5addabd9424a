"""The segmented walk of the single-channel kernels K5 (min depth) and K6
(overdraw) on the CPU: the plain mirror of the split
(render/composite.py min_depth_plain / overdraw_plain with seg_chunks=)
against the JAX kernels in interpret mode, bit for bit, on a banded shadow
cubemap and on a frame whose tiles hold several segments; the fold of the
segments in other orders; and a NaN depth."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mesh2splat_tpu.ops.projection import project_splats as j_project
from mesh2splat_tpu.render import binning as JB
from mesh2splat_tpu.render import composite as JCOMP
from mesh2splat_tpu.render import shadows as JS
from mesh2splat_tpu.types import SplatFormat as JSF
from mesh2splat_tpu.types import Splats as JSplats
from mesh2splat_tpu.types import make_camera as j_camera

from mesh2splat_torch import kernels
from mesh2splat_torch.render import composite as TCOMP

SEG_CHUNKS = (1, 2, 8)
VARIANTS = {"min_depth": "depth", "overdraw": "overdraw"}
PLAIN = {"min_depth": TCOMP.min_depth_plain,
         "overdraw": TCOMP.overdraw_plain}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small torch ops: one thread each keeps them from contending
    with the suite's other workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _splats(rng, n, pos_lo, pos_hi, scale_lo, scale_hi):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return JSplats(
        pos=jnp.asarray(rng.uniform(pos_lo, pos_hi, (n, 3)), jnp.float32),
        color=jnp.asarray(rng.uniform(0.05, 1, (n, 4)), jnp.float32),
        scale=jnp.asarray(rng.uniform(scale_lo, scale_hi, (n, 3)),
                          jnp.float32),
        normal=jnp.asarray(rng.normal(size=(n, 3)), jnp.float32),
        quat=jnp.asarray(q / np.linalg.norm(q, axis=-1, keepdims=True)),
        pbr=jnp.asarray(rng.uniform(0, 1, (n, 2)), jnp.float32),
        valid=jnp.ones((n,), bool))


@functools.lru_cache(maxsize=None)
def _case(scene, name):
    """(fields, tile_starts, height, ty, tx, the JAX kernel's image) of
    ``scene`` binned for kernel ``name``, as CPU tensors and numpy.

    "cubemap": 1500 splats around the light through the fused shadow prep,
    binned band-clamped into the 64^2 cubemap's tall image; "frame": 2600
    large splats over a 64x64 frame, so every tile holds 17 or more chunks
    (three segments of 8)."""
    variant = VARIANTS[name]
    rng = np.random.default_rng(21 if scene == "cubemap" else 22)
    if scene == "cubemap":
        size = 64
        merged, band, need = JS._shadow_prep_fused(
            _splats(rng, 1500, -1, 1, 0.01, 0.06),
            jnp.asarray([0.2, -0.1, 0.3], jnp.float32), jnp.float32(4.0),
            1.0, size)
        w, h = size, 6 * size
        binned = JB.bin_pairs(merged, w, h, JB.round_pow2_budget(need),
                              variant=variant, differentiable=False,
                              band_ty=band)
    else:
        w = h = 64
        cam = j_camera(eye=[0, 0, 5], center=[0, 0, 0], up=[0, 1, 0],
                       fov_y_rad=np.pi / 3, width=w, height=h)
        proj = j_project(_splats(rng, 2600, -0.6, 0.6, 0.2, 0.5), cam,
                         std_dev=1.0, splat_format=JSF.PLY_3DGS,
                         has_pbr=True)
        binned = JB.bin_pairs(proj, w, h, 1 << 16, variant=variant,
                              differentiable=False)
    ty, tx = JB.tiles_for(w, h)
    jk = JCOMP.min_depth_tiles if name == "min_depth" else \
        JCOMP.overdraw_tiles
    ref = np.asarray(jk(binned, jnp.asarray([h], jnp.int32), ty, tx, True))
    return (torch.from_numpy(np.array(binned.fields)),
            torch.from_numpy(np.array(binned.tile_starts)), h, ty, tx, ref)


def _segments(starts, seg):
    return kernels.segment_table(starts, seg).long()


@pytest.mark.parametrize("seg", SEG_CHUNKS)
@pytest.mark.parametrize("scene", ["cubemap", "frame"])
@pytest.mark.parametrize("name", ["min_depth", "overdraw"])
def test_segmented_plain_matches_jax(name, scene, seg):
    """Each segment of ``seg`` chunks walked alone from the identity and the
    partials folded: the JAX kernel's image, bit for bit."""
    fields, starts, h, ty, tx, ref = _case(scene, name)
    nc = TCOMP._tile_ranges(starts)[3]
    first = _segments(starts, seg)
    nseg = first[1:] - first[:-1]
    # the split is not vacuous: some tile holds several segments
    if scene == "frame":
        assert int(nc.min()) >= 17 and int(nseg.max()) >= 3
    else:
        assert int(nc.max()) >= 3 and int(nseg.max()) >= -(-3 // seg)
    got = PLAIN[name](fields, starts, h, ty, tx, seg_chunks=seg).numpy()
    if name == "min_depth":
        covered = ref < 1e37
        assert 0.02 < covered.mean() <= 1.0
    else:
        assert ref.max() >= 20
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("order", ["reversed", "shuffled"])
@pytest.mark.parametrize("name", ["min_depth", "overdraw"])
def test_segment_fold_order_free(name, order):
    """Folding the segments of one chunk each in reversed or shuffled order
    (numpy seed) gives the bits of the ascending fold and of the
    unsegmented walk, on both scenes."""
    for scene in ("cubemap", "frame"):
        fields, starts, h, ty, tx, ref = _case(scene, name)
        n_seg = int(_segments(starts, 1)[-1])
        perm = (np.arange(n_seg)[::-1] if order == "reversed" else
                np.random.default_rng(3).permutation(n_seg))
        plain = PLAIN[name]
        got = plain(fields, starts, h, ty, tx, seg_chunks=1,
                    fold_order=perm.copy())
        asc = plain(fields, starts, h, ty, tx, seg_chunks=1)
        whole = plain(fields, starts, h, ty, tx)
        assert torch.equal(got, asc) and torch.equal(got, whole)
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("seg", [None, 1, 8])
def test_min_depth_plain_nan_depth(seg):
    """A NaN depth gives NaN at the pixels its pair covers, in the
    unsegmented and the segmented walk, whatever the fold order, and leaves
    every other pixel as it was."""
    fields, starts, h, ty, tx, ref = _case("frame", "min_depth")
    fields = fields.clone()
    live = int(starts[-1])
    bad = np.random.default_rng(4).choice(live, 5, replace=False)
    fields[5, torch.from_numpy(bad)] = float("nan")
    kw = dict(seg_chunks=seg)
    got = TCOMP.min_depth_plain(fields, starts, h, ty, tx, **kw)
    if seg:
        n_seg = int(_segments(starts, seg)[-1])
        rev = TCOMP.min_depth_plain(fields, starts, h, ty, tx,
                                    fold_order=np.arange(n_seg)[::-1].copy(),
                                    **kw)
        assert torch.equal(torch.isnan(got), torch.isnan(rev))
    nan = torch.isnan(got).numpy()
    # the pixels a NaN pair covers: those its depth alone decides
    alone = fields.clone()
    keep = torch.zeros(alone.shape[1], dtype=torch.bool)
    keep[torch.from_numpy(bad)] = True
    alone[5] = torch.where(keep, torch.zeros(()), alone[5].abs() + 1.0)
    mark = TCOMP.min_depth_plain(alone, starts, h, ty, tx).numpy() == 0.0
    assert nan.any()
    np.testing.assert_array_equal(nan, mark)
    np.testing.assert_array_equal(got.numpy()[~nan], ref[~nan])
