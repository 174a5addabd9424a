"""One rank of mesh2splat_torch's data-parallel paths on the CPU (gloo):

    python tests/torch_mp_worker.py RANK WORLD INIT_URL INPUTS.npz OUT.npz

Joins WORLD processes through INIT_URL (e.g. file:///.../store), reads the
inputs test_torch_parallel.py wrote (numpy, made from seeds) and runs, over
a one-axis ``dp`` mesh of all the ranks:
  conv.*  convert_sharded's shard of this rank (every splat field);
  dp.*    one train_step_fn(mesh=) step: the loss and the averaged
          gradients Adam took;
  ras.band  rasterize_sharded's band of this rank;
  fit.hist  fit_splats(devices_mesh=)'s loss history;
and writes them to OUT.npz. Imports no jax: only torch and the port.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from mesh2splat_torch import state  # noqa: E402
from mesh2splat_torch.ops.conversion import ConversionConfig  # noqa: E402
from mesh2splat_torch.parallel import sharding  # noqa: E402
from mesh2splat_torch.train import fit  # noqa: E402


def unpack(inputs, prefix):
    return {k[len(prefix) + 1:]: inputs[k] for k in inputs.files
            if k.startswith(prefix + ".")}


def main():
    rank, world, url, in_path, out_path = sys.argv[1:6]
    torch.set_num_threads(1)
    sharding.init_distributed(url, int(world), int(rank), platform="cpu")
    try:
        mesh = sharding.make_mesh()
        inputs = np.load(in_path)
        out = {}

        geom = state.mesh(unpack(inputs, "conv.mesh"), "cpu")
        mat = state.material(unpack(inputs, "conv.mat"), "cpu")
        res, layers = (int(v) for v in inputs["conv.config"])
        sp = sharding.convert_sharded(geom, mat, *geom.bbox(),
                                      ConversionConfig(res, layers), mesh)
        out.update({f"conv.{k}": v
                    for k, v in state.splats_to_numpy(sp).items()})

        start = state.splats(unpack(inputs, "dp.start"), "cpu")
        cams = state.cameras(unpack(inputs, "dp.cam"), "cpu")
        targets = torch.from_numpy(inputs["dp.targets"])
        size = int(inputs["dp.size"])
        params = fit.SplatParams.from_splats(start)
        opt = torch.optim.Adam(params.parameters(), lr=1e-2)
        step = fit.train_step_fn(opt, size, size, mesh=mesh)
        out["dp.loss"] = step(params, start.valid, cams, targets).numpy()
        out.update({f"dp.grad.{k}": v.grad.numpy()
                    for k, v in params.as_dict().items()
                    if v.grad is not None})

        proj = state.projected(unpack(inputs, "ras.proj"), "cpu")
        w, h = (int(v) for v in inputs["ras.size"])
        out["ras.band"] = sharding.rasterize_sharded(
            proj, w, h, mesh, albedo_only=True).numpy()

        _, hist = fit.fit_splats(
            start, cams, targets,
            fit.FitConfig(steps=int(inputs["fit.steps"]), lr=1e-2,
                          width=size, height=size),
            devices_mesh=mesh, device="cpu")
        out["fit.hist"] = np.asarray(hist)
        np.savez(out_path, **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
