"""PLY export/import in mesh2splat_torch vs mesh2splat_tpu: the same arrays
write byte-identical files in all three formats, and read back alike."""

import numpy as np
import pytest
import torch

from mesh2splat_tpu.io import ply as JPLY

from mesh2splat_torch.io import ply as TPLY
from mesh2splat_torch.types import Splats


def _arrays(n=300, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    color = rng.uniform(0, 1, (n, 4)).astype(np.float32)
    color[:5, 3] = 1.0      # opacity 1 encodes to +inf
    return {"pos": rng.normal(size=(n, 3)).astype(np.float32),
            "color": color,
            "scale": rng.uniform(1e-3, 2, (n, 3)).astype(np.float32),
            "normal": nrm, "quat": q,
            "pbr": rng.uniform(0, 1, (n, 2)).astype(np.float32)}


@pytest.mark.parametrize("fmt", [0, 1, 2])
def test_write_ply_byte_identical(fmt, tmp_path):
    """The port's numpy writer is byte-identical to the JAX package's, and
    the port's default writer (its C++ codec) to the JAX default (the same
    codec). The two codecs' log() differ from numpy's by an ulp on some
    scales, so between the numpy file and the default one the decoded
    values are compared."""
    arrs = _arrays()
    a, b = tmp_path / "jax.ply", tmp_path / "port.ply"
    JPLY.write_ply(str(a), arrs, fmt=fmt, scale_multiplier=0.0039,
                   use_native=False)
    TPLY.write_ply(str(b), arrs, fmt=fmt, scale_multiplier=0.0039,
                   use_native=False)
    assert a.read_bytes() == b.read_bytes()
    JPLY.write_ply(str(a), arrs, fmt=fmt, scale_multiplier=0.0039)
    c = tmp_path / "port_default.ply"
    TPLY.write_ply(str(c), arrs, fmt=fmt, scale_multiplier=0.0039)
    assert a.read_bytes() == c.read_bytes()
    ja, jp = JPLY.read_ply(str(a))
    ta, tp = TPLY.read_ply(str(b))
    assert jp == tp == (fmt in (1, 2))
    assert ja.keys() == ta.keys()
    for k in ja:
        np.testing.assert_allclose(ta[k], ja[k], atol=1e-6, rtol=1e-6,
                                   err_msg=k)


def test_splats_roundtrip_through_port(tmp_path):
    """Splats on a device -> live rows -> PLY -> Splats again."""
    arrs = _arrays(50, seed=1)
    sp = TPLY.arrays_to_splats(arrs, capacity=64, device="cpu")
    assert isinstance(sp, Splats) and sp.capacity == 64
    assert int(sp.count()) == 50
    back = TPLY.splats_to_arrays(sp)
    for k in arrs:
        np.testing.assert_array_equal(back[k], arrs[k])
    path = tmp_path / "s.ply"
    TPLY.write_ply(str(path), back, fmt=0)
    again, _ = TPLY.read_ply(str(path))
    np.testing.assert_allclose(again["pos"], arrs["pos"], atol=1e-6)
    assert torch.equal(sp.valid[:50], torch.ones(50, dtype=torch.bool))
