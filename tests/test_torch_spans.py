"""The port's spans (``utils.profiling.annotate``): under a torch.profiler
that records CPU activity, ``Scene.convert`` and a FINAL ``Scene.render``
with shadows open every span of the conversion's and the frame's layers,
nested as the calls nest; none is a user annotation (the profiler would
copy it onto the device's timeline); outside a profiler none is recorded."""

import functools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mesh2splat_torch import scene as scene_mod
from mesh2splat_torch.io import gltf
from mesh2splat_torch.io.gltf import GltfPrimitive
from mesh2splat_torch.render import pipeline, shadows
from mesh2splat_torch.render.pipeline import FrameConfig
from mesh2splat_torch.scene import Scene
from mesh2splat_torch.types import RenderMode
from mesh2splat_torch.utils.profiling import annotate

PX = 64

# (parent, child): each span and the innermost span around it (None for an
# entry). Projection runs in the frame's calibration and in its G-buffer;
# binning in the shadow cubemap and in the frame.
NESTING = {
    (None, "m2s.convert"),
    ("m2s.convert", "m2s.convert.bbox"),
    ("m2s.convert", "m2s.convert.calibrate"),
    ("m2s.convert", "m2s.convert.slots"),
    ("m2s.convert", "m2s.convert.fragment"),
    (None, "m2s.render"),
    ("m2s.render", "m2s.render.calibrate"),
    ("m2s.render.calibrate", "m2s.render.project"),
    ("m2s.render", "m2s.render.shadow"),
    ("m2s.render.shadow", "m2s.render.bin"),
    ("m2s.render", "m2s.render.project"),
    ("m2s.render", "m2s.render.bin"),
    ("m2s.render", "m2s.render.composite"),
    ("m2s.render", "m2s.render.resolve"),
}


def _textured_quad_scene():
    v = np.array([[-0.5, -0.5, 0], [0.5, -0.5, 0], [0.5, 0.5, 0],
                  [-0.5, 0.5, 0]], np.float32)
    tris = np.array([[0, 1, 2], [0, 2, 3]])
    rng = np.random.default_rng(4)
    prim = GltfPrimitive(
        name="quad", tri_pos=v[tris],
        tri_normal=np.broadcast_to([0, 0, 1.0], (2, 3, 3)).astype(np.float32),
        tri_tangent=np.broadcast_to([1, 0, 0, 1.0], (2, 3, 4))
        .astype(np.float32),
        tri_uv=(v[tris][..., :2] + 0.5).astype(np.float32),
        base_color_factor=np.ones(4, np.float32), metallic_factor=1.0,
        roughness_factor=1.0,
        base_color_tex=rng.random((8, 8, 4), dtype=np.float32),
        normal_tex=None, metallic_roughness_tex=None)
    return Scene(primitives=[(*gltf.to_device(prim, "cpu"), prim)])


def _entries(sc):
    splats = sc.convert(resolution=16, layers=2)
    img = sc.render(splats, eye=[0.3, 0.2, 2.0], width=PX, height=PX,
                    mode=RenderMode.FINAL, shadows=True)
    assert img.shape == (PX, PX, 3) and bool(torch.isfinite(img).all())


@pytest.fixture
def small_shadows(monkeypatch):
    """The frame's shadow cubemap at 32^2 a face, through the tiled path
    (binning and the min-depth walk) that the card takes at full size."""
    monkeypatch.setattr(scene_mod, "FrameConfig",
                        functools.partial(FrameConfig, shadow_size=32))
    monkeypatch.setattr(pipeline, "render_shadow_cubemap", functools.partial(
        shadows.render_shadow_cubemap, method="tiled"))


def _m2s_events(prof):
    return [e for e in prof.profiler.kineto_results.events()
            if e.name().startswith("m2s.")]


def _nesting(events):
    """{(parent, child)}: each span's innermost enclosing span."""
    spans = sorted(((e.start_ns(), -e.end_ns(), e.name()) for e in events))
    pairs, stack = set(), []
    for s, neg_e, name in spans:
        while stack and stack[-1][0] <= s:
            stack.pop()
        pairs.add((stack[-1][1] if stack else None, name))
        stack.append((-neg_e, name))
    return pairs


def test_spans_nest_as_the_calls(small_shadows):
    sc = _textured_quad_scene()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _entries(sc)
    events = _m2s_events(prof)
    assert _nesting(events) == NESTING
    names = [e.name() for e in events]
    assert names.count("m2s.convert") == names.count("m2s.render") == 1
    # projection: once in the frame's calibration, once for its G-buffer
    assert names.count("m2s.render.project") == 2
    # host events of the profiler, never device-side annotations
    assert not any(e.is_user_annotation() for e in events)
    assert all(e.device_type() == torch.autograd.DeviceType.CPU
               for e in events)


def test_no_span_outside_a_profiler(small_shadows):
    sc = _textured_quad_scene()
    _entries(sc)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(8).sum()
    assert _m2s_events(prof) == []
    with annotate("m2s.alone"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with annotate("m2s.alone"):
            torch.ones(8).sum()
    assert [e.name() for e in _m2s_events(prof)] == ["m2s.alone"]


def test_fragment_vjp_span_in_a_texture_gradient():
    """A texture gradient through the conversion runs the fragment VJP
    once, in the span ``m2s.convert.fragment_vjp``, which opens after the
    forward's spans have closed (nothing else of a conversion or a frame
    runs in a backward)."""
    import dataclasses

    from mesh2splat_torch.ops.conversion import ConversionConfig, convert
    from mesh2splat_torch.train import fit
    from mesh2splat_torch.types import SplatFormat, make_camera

    mesh, mat, _ = _textured_quad_scene().primitives[0]
    lo, hi = mesh.bbox()
    cfg = ConversionConfig(resolution=16, layers=2)
    cam = make_camera(eye=[0.3, 0.2, 2.0], center=[0, 0, 0], up=[0, 1, 0],
                      fov_y_rad=1.0, width=PX, height=PX, device="cpu")
    tex = mat.base_color.clone().requires_grad_(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        splats = convert(mesh, dataclasses.replace(mat, base_color=tex), lo,
                         hi, cfg)
        img = fit.render_rgb(splats, cam, PX, PX,
                             std_dev=cfg.scale_multiplier,
                             splat_format=SplatFormat.MESH2SPLAT)
        img.mean().backward()
    assert bool(tex.grad.abs().sum() > 0)
    events = _m2s_events(prof)
    vjp = [e for e in events if e.name() == "m2s.convert.fragment_vjp"]
    assert len(vjp) == 1 and not vjp[0].is_user_annotation()
    forward_end = max(e.end_ns() for e in events if e is not vjp[0])
    assert vjp[0].start_ns() >= forward_end
    assert (None, "m2s.convert.fragment_vjp") in _nesting(events)
