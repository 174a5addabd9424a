"""mesh2splat_torch's CLI on the CPU (--device cpu) against the JAX
package's CLI (tests/test_cli.py) on the golden helmet GLB of
tests/golden_asset.py: the calibrated conversion and its drop report, the
PLY against the JAX CLI's, the rendered PNGs, the split screen and the
batch queue with per-item failure isolation."""

import pathlib
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from golden_asset import build_helmet_glb

from mesh2splat_tpu import cli as JCLI
from mesh2splat_tpu.io import ply as JPLY

from mesh2splat_torch import cli
from mesh2splat_torch.io import ply as TPLY

RENDER = ["--resolution", "64", "--width", "128", "--height", "96",
          "--eye", "0,0.3,3.5"]


@pytest.fixture(scope="module")
def helmet_glb(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli") / "helmet.glb"
    build_helmet_glb(str(path))
    return str(path)


def test_convert_zero_drops_and_jax_cli_splats(helmet_glb, tmp_path, capsys):
    """convert at resolution 256 reports zero drops, and its PLY holds the
    JAX CLI's splats: the same count, each value within 2e-5 (the golden
    rule; the rows come in the same slot order)."""
    out, ref = tmp_path / "port.ply", tmp_path / "jax.ply"
    cli.main(["convert", helmet_glb, str(out), "--resolution", "256",
              "--device", "cpu"])
    captured = capsys.readouterr()
    assert "dropped 0," in captured.out and "gaussians" in captured.out
    assert "WARNING" not in captured.err
    JCLI.main(["convert", helmet_glb, str(ref), "--resolution", "256"])
    got, has_pbr = TPLY.read_ply(str(out))
    want, _ = JPLY.read_ply(str(ref))
    assert not has_pbr
    assert got["pos"].shape[0] == want["pos"].shape[0] > 100_000
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=2e-5, rtol=0,
                                   err_msg=k)


def test_convert_reports_drops(helmet_glb, tmp_path, capsys):
    """A starved budget warns with the overflow counters."""
    cli.main(["convert", helmet_glb, str(tmp_path / "starved.ply"),
              "--resolution", "256", "--layers", "1", "--device", "cpu"])
    err = capsys.readouterr().err
    assert "WARNING" in err and "raise --layers" in err


@pytest.mark.parametrize("mode", ["albedo", "final"])
def test_render_matches_jax_cli(helmet_glb, tmp_path, mode):
    """The rendered PNG within one 8-bit level of the JAX CLI's."""
    out, ref = tmp_path / "port.png", tmp_path / "jax.png"
    cli.main(["render", helmet_glb, str(out), "--mode", mode, *RENDER,
              "--device", "cpu"])
    JCLI.main(["render", helmet_glb, str(ref), "--mode", mode, *RENDER])
    got = np.asarray(Image.open(out)).astype(int)
    want = np.asarray(Image.open(ref)).astype(int)
    assert got.shape == want.shape == (96, 128, 3)
    assert got.mean() > 5
    assert np.abs(got - want).max() <= 1


def test_render_split_screen(helmet_glb, tmp_path):
    """--split renders the mesh-vs-splat compare: a white divider column,
    the mesh on the left, the splats on the right; --split refuses
    --shadows before loading anything."""
    out = tmp_path / "split.png"
    cli.main(["render", helmet_glb, str(out), *RENDER, "--split", "0.5",
              "--device", "cpu"])
    img = np.asarray(Image.open(out))
    assert img.shape[:2] == (96, 128)
    assert img[:, 64].mean() > 250
    assert img[:, :60].mean() > 5 and img[:, 68:].mean() > 5
    with pytest.raises(SystemExit, match="split"):
        cli.main(["render", "absent.glb", str(out), "--split", "0.5",
                  "--shadows", "--device", "cpu"])


def test_batch_isolates_failures(helmet_glb, tmp_path, capsys):
    """batch over two GLBs and one broken file converts the two and reports
    the third."""
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    shutil.copy(helmet_glb, in_dir / "a.glb")
    shutil.copy(helmet_glb, in_dir / "b.glb")
    (in_dir / "broken.glb").write_bytes(b"not a glb")
    out_dir = tmp_path / "out"
    cli.main(["batch", str(in_dir), str(out_dir), "--resolution", "128",
              "--device", "cpu"])
    captured = capsys.readouterr()
    assert "batch done: 2 converted, 1 failed" in captured.out
    assert "FAILED broken.glb" in captured.err
    assert sorted(p.name for p in pathlib.Path(out_dir).iterdir()) == \
        ["a.ply", "b.ply"]


def test_device_defaults_to_cuda(helmet_glb, tmp_path, monkeypatch):
    """Without --device the CLI asks for the card and raises where there is
    none; it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["convert", helmet_glb, str(tmp_path / "x.ply")])
