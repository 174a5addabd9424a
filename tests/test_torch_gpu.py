"""mesh2splat_torch's CUDA kernels against their plain PyTorch versions on
the card, and the slice (conversion, and a training step) on the card
against the same code on the CPU.
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
    out = kernels.composite_forward(b.fields, b.tile_starts, height=130,
                                    ty=ty, tx=tx, albedo_only=albedo_only)
    ref = TCOMP.composite_plain(b.fields, b.tile_starts, 130, ty, tx,
                                 albedo_only)
    assert float((out - ref).abs().max()) <= 1e-3


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
