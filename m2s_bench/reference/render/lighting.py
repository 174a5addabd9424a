"""Deferred PBR resolve: full-screen GGX point-light shading over the splat
G-buffer (counterpart of ``mesh2splat_tpu.render.lighting``; the
reference's gaussianSplattingDeferredPS.glsl). Elementwise tensor code."""

from __future__ import annotations

import dataclasses

import torch

from ..types import RenderMode, resolve_device

# the reference defines PI as 22/7 (deferredPS:8); kept for output parity
PI_REF = 22.0 / 7.0


@dataclasses.dataclass
class PointLight:
    position: torch.Tensor   # (3,)
    color: torch.Tensor      # (3,)
    intensity: float

    @staticmethod
    def default(device="cuda") -> "PointLight":
        dev = resolve_device(device)
        return PointLight(
            position=torch.tensor([2.0, 2.0, 2.0], device=dev),
            color=torch.ones(3, device=dev),
            intensity=10.0,
        )


def _norm(v):
    return torch.sqrt(v[..., 0:1] * v[..., 0:1] + v[..., 1:2] * v[..., 1:2]
                      + v[..., 2:3] * v[..., 2:3])


def _dot(a, b):
    return a[..., 0:1] * b[..., 0:1] + a[..., 1:2] * b[..., 1:2] + \
        a[..., 2:3] * b[..., 2:3]


def _fresnel_schlick(cos_theta, f0):
    return f0 + (1.0 - f0) * torch.clamp(1.0 - cos_theta, 0.0, 1.0) ** 5


def _distribution_ggx(n_dot_h, roughness):
    a2 = (roughness * roughness) ** 2
    denom = n_dot_h * n_dot_h * (a2 - 1.0) + 1.0
    return a2 / (PI_REF * denom * denom)


def _geometry_schlick_ggx(n_dot_v, roughness):
    r = roughness + 1.0
    k = (r * r) / 8.0
    return n_dot_v / (n_dot_v * (1.0 - k) + k)


@torch.no_grad()
def deferred_resolve(gbuffer: dict, camera_pos: torch.Tensor,
                     light: PointLight,
                     render_mode: RenderMode = RenderMode.FINAL,
                     shadow_factor: torch.Tensor | None = None) -> torch.Tensor:
    """G-buffer -> final (H, W, 3) image. shadow_factor: optional (H, W) in
    [0, 1]; 0 (fully lit) when omitted."""
    albedo = gbuffer["albedo"][..., :3]
    mode = int(render_mode)
    if mode == int(RenderMode.PBR):
        mr = gbuffer["metal_rough"]
        return torch.cat([mr[..., 0:1], mr[..., 1:2],
                          torch.zeros_like(mr[..., :1])], dim=-1)
    if mode != int(RenderMode.FINAL):
        return albedo

    pos = gbuffer["position"][..., :3]
    n = gbuffer["normal"][..., :3] * 2.0 - 1.0
    n = n / (_norm(n) + 1e-12)
    metallic = gbuffer["metal_rough"][..., 0:1]
    roughness = gbuffer["metal_rough"][..., 1:2]
    shadow = 0.0 if shadow_factor is None else shadow_factor[..., None]

    albedo_lin = torch.clamp(albedo, min=0.0) ** 2.2
    l_vec = light.position - pos
    d = _norm(l_vec)
    L = l_vec / (d + 1e-12)
    v_vec = camera_pos - pos
    V = v_vec / (_norm(v_vec) + 1e-12)
    H = L + V
    H = H / (_norm(H) + 1e-12)

    attenuation = 1.0 / torch.clamp(d * d, min=1e-12)
    radiance = light.color * light.intensity * attenuation

    n_dot_l = torch.clamp(_dot(n, L), min=0.0)
    n_dot_v = torch.clamp(_dot(n, V), min=0.0)
    n_dot_h = torch.clamp(_dot(n, H), min=0.0)
    h_dot_v = torch.clamp(_dot(H, V), min=0.0)

    f0 = 0.04 * (1.0 - metallic) + albedo_lin * metallic
    F = _fresnel_schlick(h_dot_v, f0)
    ndf = _distribution_ggx(n_dot_h, roughness)
    geo = _geometry_schlick_ggx(n_dot_v, roughness) * _geometry_schlick_ggx(
        n_dot_l, roughness)
    specular = (ndf * geo * F) / (4.0 * n_dot_v * n_dot_l + 1e-4)
    k_d = (1.0 - F) * (1.0 - metallic)
    lo = (k_d * albedo_lin / PI_REF + specular) * radiance * n_dot_l * (1.0 - shadow)
    ambient = 0.3 * albedo_lin
    color = ambient + lo
    color = color / (color + 1.0)
    return torch.clamp(color, 0.0, 1.0) ** (1.0 / 2.2)
