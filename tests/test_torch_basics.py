"""mesh2splat_torch vs mesh2splat_tpu on the small pieces: codecs, quat,
camera, segments, triplanar, the tap atlas; plus the port's import and
device rules (no JAX, no silent CPU)."""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mesh2splat_tpu import types as JT
from mesh2splat_tpu.ops import conversion as JC
from mesh2splat_tpu.ops import fragment as JF
from mesh2splat_tpu.ops import quat as JQ
from mesh2splat_tpu.ops import segments as JS
from mesh2splat_tpu.ops import triplanar as JTP

from mesh2splat_torch import types as TT
from mesh2splat_torch.ops import conversion as TC
from mesh2splat_torch.ops import fragment as TF
from mesh2splat_torch.ops import quat as TQ
from mesh2splat_torch.ops import segments as TS
from mesh2splat_torch.ops import triplanar as TTP
from torch_parity import jax_mesh_material, sphere_mesh, torch_mesh_material

RNG = np.random.default_rng(0)
X = RNG.uniform(-2, 2, (64, 3)).astype(np.float32)
UNIT = np.clip(RNG.uniform(-0.1, 1.1, (64, 4)), 0, 1).astype(np.float32)


@pytest.mark.parametrize("name,arg", [
    ("sigmoid", X), ("inv_sigmoid", UNIT), ("color_to_sh0", UNIT),
    ("sh0_to_color", X), ("encode_normal", X), ("decode_normal", UNIT),
    ("oct_encode", X), ("oct_decode", UNIT[:, :2]),
    ("srgb_to_linear", UNIT), ("linear_to_srgb", UNIT),
])
def test_codecs_match(name, arg):
    ref = np.asarray(getattr(JT, name)(jnp.asarray(arg)))
    out = getattr(TT, name)(torch.from_numpy(arg)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=1e-6)


def test_exponential_depth_and_camera_match():
    d = np.linspace(0.05, 120, 50).astype(np.float32)
    np.testing.assert_allclose(
        TT.exponential_depth(torch.from_numpy(d), 0.1, 100.0).numpy(),
        np.asarray(JT.exponential_depth(jnp.asarray(d), 0.1, 100.0)),
        atol=1e-6)
    kw = dict(eye=[0.3, 0.4, 3.0], center=[0, 0.1, 0], up=[0, 1, 0],
              fov_y_rad=0.9, width=320, height=200)
    jc = JT.make_camera(**kw)
    tc = TT.make_camera(**kw, device="cpu")
    np.testing.assert_array_equal(tc.world_to_view.numpy(),
                                  np.asarray(jc.world_to_view))
    np.testing.assert_array_equal(tc.view_to_clip.numpy(),
                                  np.asarray(jc.view_to_clip))
    assert (tc.near, tc.far) == (float(jc.near), float(jc.far))
    trs = ((0.1, -0.2, 0.3), (0.9, 0.1, 0.3, -0.2), (1.5, 0.5, 2.0))
    np.testing.assert_allclose(TT.compose_trs(*trs, device="cpu").numpy(),
                               np.asarray(JT.compose_trs(*trs)), atol=1e-6)


def test_quat_match():
    q = RNG.normal(size=(200, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    s = RNG.uniform(0.01, 1, (200, 3)).astype(np.float32)
    tq = torch.from_numpy(q)
    R = np.array(JQ.quat_to_mat(jnp.asarray(q)))
    np.testing.assert_allclose(TQ.quat_to_mat(tq).numpy(), R, atol=1e-6)
    np.testing.assert_allclose(TQ.mat_to_quat(torch.from_numpy(R)).numpy(),
                               np.asarray(JQ.mat_to_quat(jnp.asarray(R))),
                               atol=1e-6)
    np.testing.assert_allclose(
        TQ.quat_mul(tq, tq.flip(0)).numpy(),
        np.asarray(JQ.quat_mul(jnp.asarray(q), jnp.asarray(q[::-1]))),
        atol=1e-6)
    np.testing.assert_allclose(
        TQ.quat_normalize(tq * 3).numpy(),
        np.asarray(JQ.quat_normalize(jnp.asarray(q * 3))), atol=1e-6)
    np.testing.assert_allclose(
        TQ.covariance_from_quat_scale(tq, torch.from_numpy(s)).numpy(),
        np.asarray(JQ.covariance_from_quat_scale(jnp.asarray(q),
                                                 jnp.asarray(s))),
        atol=1e-6)


def test_splats_count_and_compact_match():
    rng = np.random.default_rng(4)
    fields = {k: rng.normal(size=(50, w)).astype(np.float32) for k, w in
              (("pos", 3), ("color", 4), ("scale", 3), ("normal", 3),
               ("quat", 4), ("pbr", 2))}
    fields["valid"] = rng.uniform(size=50) > 0.4
    ref = JT.Splats(**{k: jnp.asarray(v) for k, v in fields.items()})
    out = TT.Splats(**{k: torch.from_numpy(v) for k, v in fields.items()})
    assert int(out.count()) == int(ref.count())
    jc, tc = ref.compact(), out.compact()
    for k in fields:
        np.testing.assert_array_equal(getattr(tc, k).numpy(),
                                      np.asarray(getattr(jc, k)))


@pytest.mark.parametrize("capacity", [40, 200, 1000])
def test_segments_exact(capacity):
    """Random counts, including an over-budget total at capacity 40."""
    rng = np.random.default_rng(capacity)
    counts = rng.integers(0, 6, 80).astype(np.int32)
    counts[rng.integers(0, 80, 10)] = 0
    tc = torch.from_numpy(counts)
    j_off, j_tot = JS.alloc_slots(jnp.asarray(counts), capacity)
    t_off, t_tot = TS.alloc_slots(tc, capacity)
    np.testing.assert_array_equal(t_off.numpy(), np.asarray(j_off))
    assert int(t_tot) == int(j_tot)
    value = np.cumsum(rng.integers(0, 3, 80)).astype(np.int32)
    extra = rng.integers(0, 50, (2, 80)).astype(np.int32)
    for a, b in zip(
        JS.expand_monotone(j_off, jnp.asarray(counts), capacity,
                           value=jnp.asarray(value)),
        TS.expand_monotone(t_off, tc, capacity,
                           value=torch.from_numpy(value)),
    ):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(
        TS.fill_value(t_off, tc, capacity, torch.from_numpy(value)).numpy(),
        np.asarray(JS.fill_value(j_off, jnp.asarray(counts), capacity,
                                 jnp.asarray(value))))
    for a, b in zip(
        JS.expand_to_slots(j_off, jnp.asarray(counts), capacity,
                           extra=jnp.asarray(extra)),
        TS.expand_to_slots(t_off, tc, capacity,
                           extra=torch.from_numpy(extra)),
    ):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    keys = np.sort(rng.integers(0, 12, 300)).astype(np.int32)
    np.testing.assert_array_equal(
        TS.segment_starts(torch.from_numpy(keys), 10).numpy(),
        np.asarray(JS.segment_starts(jnp.asarray(keys), 10)))


def _owner_counts(case):
    """(counts, capacity) of one owner_of_slots case."""
    rng = np.random.default_rng(sum(map(ord, case)))
    counts = rng.integers(1, 7, 90).astype(np.int32)
    if case.startswith("zeros"):
        share = float(case.split("_")[1])
        counts[rng.uniform(size=90) < share] = 0
        return counts, 400
    if case == "zero_runs":      # leading and trailing runs of zero counts
        counts[rng.uniform(size=90) < 0.5] = 0
        counts[:17] = 0
        counts[-23:] = 0
        return counts, 300
    if case == "over_budget":    # sum(counts) > capacity
        counts[rng.uniform(size=90) < 0.3] = 0
        return counts, 120
    if case == "capacity_1":
        counts[:5] = 0
        return counts, 1
    if case == "n_1":
        return counts[:1], 8
    return np.zeros((1,), np.int32), 8   # "n_1_zero"


@pytest.mark.parametrize("case", [
    "zeros_0", "zeros_0.5", "zeros_0.95", "zeros_1", "zero_runs",
    "over_budget", "capacity_1", "n_1", "n_1_zero"])
def test_owner_of_slots_matches_fill(case):
    """Each slot's producer by the search over segment ends equals the
    clamped forward fill of producer ids, the port's and the JAX package's,
    on every slot, live and dead."""
    counts, capacity = _owner_counts(case)
    n = counts.shape[0]
    tc = torch.from_numpy(counts)
    t_off, t_tot = TS.alloc_slots(tc, capacity)
    j_off, _ = JS.alloc_slots(jnp.asarray(counts), capacity)
    owner = TS.owner_of_slots(t_off, tc, capacity)
    assert owner.dtype == torch.int64 and owner.shape == (capacity,)
    port = torch.clamp(TS.fill_value(
        t_off, tc, capacity, torch.arange(n, dtype=torch.int32)), min=0)
    jax_ = np.maximum(np.asarray(JS.fill_value(
        j_off, jnp.asarray(counts), capacity,
        jnp.arange(n, dtype=jnp.int32))), 0)
    np.testing.assert_array_equal(owner.numpy(), port.numpy())
    np.testing.assert_array_equal(owner.numpy(), jax_)
    if case == "over_budget":
        assert int(counts.sum()) > capacity == int(t_tot)
    if case in ("zeros_1", "n_1_zero"):
        assert int(t_tot) == 0 and not owner.any()


def test_triplanar_match():
    mesh, _ = sphere_mesh(300, seed=2)
    tp = mesh["tri_pos"]
    lo, hi = tp.reshape(-1, 3).min(0), tp.reshape(-1, 3).max(0)
    ref = JTP.triangle_conversion_attrs(jnp.asarray(tp), jnp.asarray(lo),
                                        jnp.asarray(hi))
    out = TTP.triangle_conversion_attrs(torch.from_numpy(tp),
                                        torch.from_numpy(lo),
                                        torch.from_numpy(hi))
    for k in ("ortho_uv", "quat", "scale", "normal_geo"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("precision", ["bf16", "f32"])
def test_atlas_bit_exact(precision):
    """pack_atlas with mips: the packed bf16 pairs round to nearest even
    exactly as astype(bfloat16) does."""
    mesh, mat = sphere_mesh(50, seed=3, tex=64)
    jm, jmat = jax_mesh_material(mesh, mat)
    _, tmat = torch_mesh_material(mesh, mat)
    ja = JC.pack_atlas(jmat, precision=precision, mips=True)
    ta = TC.pack_atlas(tmat, precision=precision, mips=True)
    assert ta.geom == ja.geom and ta.k == ja.k and ta.packed == ja.packed
    np.testing.assert_array_equal(ta.atlasT.numpy(), np.asarray(ja.atlasT))
    # and build_pair_atlas itself, packed, on a texture of odd values
    st = RNG.uniform(0, 1, (2, 32, 32, 10)).astype(np.float32)
    jat, jg = JF.build_pair_atlas(jnp.asarray(st), 2, packed=True, mips=True)
    tat, tg = TF.build_pair_atlas(torch.from_numpy(st), 2, packed=True,
                                  mips=True)
    assert tuple(tg) == tuple(jg)
    np.testing.assert_array_equal(tat.numpy(), np.asarray(jat))


_NO_JAX = """
import sys, pkgutil, importlib
sys.modules["jax"] = None
sys.modules["mesh2splat_tpu"] = None
import mesh2splat_torch
for m in pkgutil.walk_packages(mesh2splat_torch.__path__, "mesh2splat_torch."):
    importlib.import_module(m.name)
assert "jax" not in [k for k, v in sys.modules.items() if v is not None]
for name in ("train.fit", "utils.checkpoint", "render.rasterize",
             "render.shadows", "render.mesh_raster", "ops.sampling",
             "io.native", "ops.uv_unwrap", "utils.camera_controller",
             "utils.profiling", "cli", "demo", "parallel.sharding"):
    assert "mesh2splat_torch." + name in sys.modules, name
print("ok")
"""


def test_port_imports_without_jax():
    """Every module of the port, train/, utils/, parallel/, the CLI, the
    demo, shadows and the mesh raster included, imports with jax and the
    JAX package blocked."""
    out = subprocess.run([sys.executable, "-c", _NO_JAX], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip().endswith("ok")


def test_cuda_requested_without_card_raises(monkeypatch, tmp_path):
    """An entry point asked for CUDA on a machine without a card raises; it
    never moves to the CPU silently."""
    from mesh2splat_torch.scene import Scene

    from mesh2splat_torch.render.mesh_raster import rasterize_mesh
    from mesh2splat_torch.render.rasterize import rasterize_dense
    from mesh2splat_torch.render.shadows import render_shadow_cubemap
    from mesh2splat_torch.train import fit

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        TT.make_camera(eye=[0, 0, 3], center=[0, 0, 0], up=[0, 1, 0],
                       fov_y_rad=1.0, width=8, height=8)
    with pytest.raises(RuntimeError, match="cuda"):
        Scene.from_glb(str(tmp_path / "absent.glb"))
    with pytest.raises(RuntimeError, match="cuda"):
        TT.compose_trs()
    # the training entry points, the dense rasterizer, the shadow cubemap
    # and the mesh rasterizer check the device before they touch their
    # inputs
    for call in (lambda: fit.fit_splats(None, [], None, fit.FitConfig()),
                 lambda: fit.fit_textures(None, None, None, [], None,
                                          fit.FitTexturesConfig()),
                 lambda: rasterize_dense(None, 8, 8),
                 lambda: render_shadow_cubemap(None, [0, 0, 0], 1.0, 1.0),
                 lambda: rasterize_mesh(None, None, None, 8, 8)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
