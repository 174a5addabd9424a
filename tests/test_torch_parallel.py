"""mesh2splat_torch's data-parallel paths (parallel/sharding.py on
torch.distributed, fit_splats(devices_mesh=)) on the CPU, against the port
in one process and against the JAX package's shard_map versions over
make_mesh(2).

Two gloo ranks run as subprocesses of tests/torch_mp_worker.py, once for
the module, on inputs made here from seeds with numpy:
  - convert_sharded of a 101-triangle textured sphere (so the ranks' blocks
    need padding): the shards in rank order against the JAX global array;
  - one data-parallel training step on the well-conditioned scene of
    tests/test_torch_train.py (two 64x64 views, one a rank): the loss and
    the averaged gradients against the port's single-process step at
    tests/test_sharding.py's tolerances, and against the JAX sharded step
    at 1e-3 of each parameter's largest gradient;
  - rasterize_sharded in two 32-row bands against the port's single
    rasterize_tiled and the JAX rasterize_sharded (1e-3);
  - fit_splats(devices_mesh=) for 3 steps against the JAX one (rtol 1e-4).
An in-process one-rank group gives exactly the single-process results."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from mesh2splat_tpu.ops.conversion import ConversionConfig as JCfg
from mesh2splat_tpu.ops.conversion import convert as j_convert
from mesh2splat_tpu.ops.projection import project_splats as j_project
from mesh2splat_tpu.parallel import sharding as JSH
from mesh2splat_tpu.train import fit as JFIT
from mesh2splat_tpu.types import Material as JMaterial
from mesh2splat_tpu.types import RenderMode as JRM
from mesh2splat_tpu.types import SplatFormat as JSF
from mesh2splat_tpu.types import make_camera as j_camera

from mesh2splat_torch import state
from mesh2splat_torch.ops.conversion import ConversionConfig
from mesh2splat_torch.ops.conversion import convert as t_convert
from mesh2splat_torch.parallel import sharding
from mesh2splat_torch.render.tiled import rasterize_tiled
from mesh2splat_torch.train import fit as TFIT
from test_torch_train import j_mesh, quad_mesh, random_scene
from torch_parity import host, jax_mesh_material, sphere_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_mp_worker.py")
FIELDS = ("pos", "color", "scale", "normal", "quat", "pbr")
CONV = (32, 6)              # resolution, layers
RAS = (128, 64)             # width, height: two bands of TILE_H rows
FIT_STEPS = 3


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def raster_scene():
    """tests/test_sharding.py's band test at 2 bands: the quad at
    resolution 32 with strictly increasing depths, seen from (0.4, 0.3,
    2); the JAX projection's fields."""
    jm = j_mesh(quad_mesh())
    cfg = JCfg(resolution=32, layers=3)
    sp = j_convert(jm, JMaterial.default(), *jm.bbox(), cfg)
    zj = (np.arange(sp.pos.shape[0]) * 1e-5).astype(np.float32)
    sp = dataclasses.replace(
        sp, pos=sp.pos + jnp.asarray(zj)[:, None] * jnp.asarray([0, 0, 1.0]))
    w, h = RAS
    cam = j_camera(eye=[0.4, 0.3, 2], center=[0, 0, 0], up=[0, 1, 0],
                   fov_y_rad=np.pi / 3, width=w, height=h)
    return j_project(sp, cam, std_dev=cfg.scale_multiplier,
                     render_mode=JRM.ALBEDO, splat_format=JSF.MESH2SPLAT)


@pytest.fixture(scope="module")
def scenes():
    mesh, mat = sphere_mesh(101, seed=3, tex=32)
    start, cams, targets, size, _ = random_scene()
    return dict(mesh=mesh, mat=mat, start=start, cams=cams, targets=targets,
                size=size, proj=raster_scene())


@pytest.fixture(scope="module")
def ranks(scenes, tmp_path_factory):
    """The two ranks' outputs, each a dict of numpy arrays."""
    tmp = tmp_path_factory.mktemp("torch_mp")
    inputs = {}
    for prefix, fields in (("conv.mesh", scenes["mesh"]),
                           ("conv.mat", scenes["mat"]),
                           ("dp.start", host(scenes["start"])),
                           ("dp.cam", host(scenes["cams"])),
                           ("ras.proj", host(scenes["proj"]))):
        inputs.update({f"{prefix}.{k}": np.asarray(v)
                       for k, v in fields.items()})
    inputs.update({"conv.config": np.asarray(CONV), "ras.size":
                   np.asarray(RAS), "dp.targets": scenes["targets"],
                   "dp.size": np.asarray(scenes["size"]),
                   "fit.steps": np.asarray(FIT_STEPS)})
    np.savez(tmp / "inputs.npz", **inputs)
    url = f"file://{tmp}/store"
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), "2", url, str(tmp / "inputs.npz"),
         str(tmp / f"rank{r}.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO)
        for r in range(2)]
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=600)
            assert p.returncode == 0, (
                f"rank {r} failed (rc={p.returncode})\nstdout:\n{out}\n"
                f"stderr:\n{err[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]


def _concat(ranks, prefix, name):
    return np.concatenate([r[f"{prefix}.{name}"] for r in ranks])


def test_convert_sharded_matches_jax(scenes, ranks):
    """The shards in rank order: the JAX global array's count and valid
    mask exactly, its live splats within 2e-5 (the conversion's rule), and
    the single-process conversion's count."""
    jm, jmat = jax_mesh_material(scenes["mesh"], scenes["mat"])
    cfg = JCfg(*CONV)
    ref = host(JSH.convert_sharded(jm, jmat, *jm.bbox(), cfg,
                                   JSH.make_mesh(2)))
    valid = _concat(ranks, "conv", "valid")
    assert valid.shape == ref["valid"].shape
    np.testing.assert_array_equal(valid, ref["valid"])
    assert valid.sum() > 500
    for f in FIELDS:
        np.testing.assert_allclose(_concat(ranks, "conv", f)[valid],
                                   ref[f][valid], atol=2e-5, rtol=0,
                                   err_msg=f)
    tm, tmat = (state.mesh(scenes["mesh"], "cpu"),
                state.material(scenes["mat"], "cpu"))
    single = t_convert(tm, tmat, *tm.bbox(), ConversionConfig(*CONV))
    assert int(single.count()) == int(valid.sum())


def _single_step(scenes):
    """The port's loss and gradients over both views in one process."""
    params = state.splat_params(host(JFIT.SplatParams.from_splats(
        scenes["start"])), "cpu")
    valid = torch.from_numpy(np.array(scenes["start"].valid))
    size = scenes["size"]
    loss = TFIT.l2_loss(params, valid, state.cameras(scenes["cams"], "cpu"),
                        torch.from_numpy(scenes["targets"].copy()), size, size)
    loss.backward()
    return float(loss.detach()), {k: v.grad.numpy() for k, v in
                                  params.as_dict().items()
                                  if v.grad is not None}


def test_dp_step_matches_single_process(scenes, ranks):
    """Both ranks return the same loss and gradients, equal to the port's
    single-process ones at test_sharding.py's tolerances."""
    loss, grads = _single_step(scenes)
    for r in ranks:
        np.testing.assert_array_equal(r["dp.loss"], ranks[0]["dp.loss"])
        np.testing.assert_allclose(float(r["dp.loss"]), loss, rtol=1e-5)
        assert {k[len("dp.grad."):] for k in r if k.startswith("dp.grad.")} \
            == set(grads)
        for k, g in grads.items():
            np.testing.assert_array_equal(r[f"dp.grad.{k}"],
                                          ranks[0][f"dp.grad.{k}"])
            np.testing.assert_allclose(r[f"dp.grad.{k}"], g, rtol=1e-4,
                                       atol=1e-6, err_msg=k)


def test_dp_step_matches_jax_sharded(scenes, ranks):
    """Against the JAX pmean'd shard_map step over make_mesh(2) on the same
    scene: the loss to rtol 1e-5, each gradient to 1e-3 of its largest
    magnitude (the composite VJP's order of summation)."""
    start, size = scenes["start"], scenes["size"]
    params = JFIT.SplatParams.from_splats(start)
    mesh = JSH.make_mesh(2)

    def sharded(params, valid, cameras, targets):
        def local(params, valid, cameras, targets):
            return jax.lax.pmean(JFIT.l2_loss(params, valid, cameras,
                                              targets, size, size), "dp")
        return jax.shard_map(local, mesh=mesh,
                             in_specs=(P(), P(), P("dp"), P("dp")),
                             out_specs=P(), check_vma=False)(
            params, valid, cameras, targets)

    loss, grads = jax.jit(jax.value_and_grad(sharded))(
        params, start.valid, scenes["cams"], jnp.asarray(scenes["targets"]))
    np.testing.assert_allclose(float(ranks[0]["dp.loss"]), float(loss),
                               rtol=1e-5)
    ref = host(grads)
    for k, g in ref.items():
        got = ranks[0].get(f"dp.grad.{k}", np.zeros_like(g))
        np.testing.assert_allclose(got, g, rtol=1e-3,
                                   atol=1e-3 * max(np.abs(g).max(), 1e-30),
                                   err_msg=k)


def test_rasterize_sharded_bands(scenes, ranks):
    """The bands in rank order: the port's single-device tiled raster and
    the JAX rasterize_sharded over make_mesh(2), within 1e-3."""
    w, h = RAS
    bands = _concat(ranks, "ras", "band")
    assert bands.shape == (h, w, 4)
    assert bands[..., 3].max() > 0.5
    proj = scenes["proj"]
    single = rasterize_tiled(state.projected(host(proj), "cpu"), w, h,
                             albedo_only=True)["albedo"].numpy()
    np.testing.assert_allclose(bands, single, atol=1e-3, rtol=0)
    ref = np.asarray(JSH.rasterize_sharded(proj, w, h, JSH.make_mesh(2),
                                           albedo_only=True))
    np.testing.assert_allclose(bands, ref, atol=1e-3, rtol=0)


def test_fit_splats_dp_history_matches_jax(scenes, ranks):
    """fit_splats(devices_mesh=) over the two ranks: the same history on
    both, falling, and the JAX fit_splats over make_mesh(2)'s within rtol
    1e-4."""
    size = scenes["size"]
    _, ref = JFIT.fit_splats(
        scenes["start"], scenes["cams"], jnp.asarray(scenes["targets"]),
        JFIT.FitConfig(steps=FIT_STEPS, lr=1e-2, width=size, height=size),
        devices_mesh=JSH.make_mesh(2))
    hist = ranks[0]["fit.hist"]
    np.testing.assert_array_equal(ranks[1]["fit.hist"], hist)
    assert hist.shape == (FIT_STEPS,) and hist[-1] < hist[0]
    np.testing.assert_allclose(hist, ref, rtol=1e-4)


@pytest.fixture
def one_rank_mesh(tmp_path):
    sharding.init_distributed(f"file://{tmp_path}/store", 1, 0,
                              platform="cpu")
    try:
        yield sharding.make_mesh()
    finally:
        dist.destroy_process_group()


def test_one_rank_group_is_the_single_process(scenes, one_rank_mesh):
    """With one rank the shard and the band are the whole: convert_sharded
    and rasterize_sharded equal convert and rasterize_tiled bit for bit."""
    mesh = one_rank_mesh
    assert sharding.axis_rank(mesh) == (0, 1)
    tm, tmat = (state.mesh(scenes["mesh"], "cpu"),
                state.material(scenes["mat"], "cpu"))
    cfg = ConversionConfig(*CONV)
    got = state.splats_to_numpy(sharding.convert_sharded(
        tm, tmat, *tm.bbox(), cfg, mesh))
    ref = state.splats_to_numpy(t_convert(tm, tmat, *tm.bbox(), cfg))
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    w, h = RAS
    proj = state.projected(host(scenes["proj"]), "cpu")
    band = sharding.rasterize_sharded(proj, w, h, mesh, albedo_only=True)
    assert torch.equal(band, rasterize_tiled(proj, w, h,
                                             albedo_only=True)["albedo"])
    with pytest.raises(ValueError, match="TILE_H"):
        sharding.rasterize_sharded(proj, w, 48, mesh)


def test_shard_helpers(one_rank_mesh):
    """pad_to_multiple pads with zeros; shard_batch keeps a one-rank batch
    whole; mean_over and max_over of one rank are identities, a strided
    tensor included; make_mesh rejects a size other than the group's."""
    a = torch.arange(10.0).reshape(5, 2)
    p = sharding.pad_to_multiple(a, 4)
    assert p.shape == (8, 2) and torch.equal(p[:5], a) and not p[5:].any()
    assert sharding.pad_to_multiple(a, 5) is a
    assert torch.equal(sharding.shard_batch(a, one_rank_mesh), a)
    assert sharding.shard_batch([1, 2, 3], one_rank_mesh) == [1, 2, 3]
    g = torch.arange(12.0).reshape(3, 4).t()    # strided, as a grad can be
    ref = g.clone()
    assert sharding.mean_over(g, one_rank_mesh) is g and torch.equal(g, ref)
    assert torch.equal(sharding.max_over(torch.tensor(5), one_rank_mesh),
                       torch.tensor(5))
    with pytest.raises(ValueError, match="processes"):
        sharding.make_mesh(2)
