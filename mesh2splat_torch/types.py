"""Core data types of the PyTorch/CUDA port of mesh2splat.

Counterpart of ``mesh2splat_tpu.types``: the same splat model, codecs and
camera conventions, as dataclasses of torch tensors instead of JAX pytrees.

Scale/opacity conventions (reference: SURVEY.md section 2.3):
  * ``scale`` is the *raw* Jacobian column norm (|Ju|, |Jv|, 1e-7) -- sigma is
    multiplied in at render/export time.
  * ``color[..., 3]`` is opacity in [0, 1]; PLY export applies inv-sigmoid and
    import applies sigmoid.
  * ``quat`` is stored (w, x, y, z).
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

SH_C0 = 0.28209479177387814


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. Asking for CUDA on a machine
    without a usable card raises: nothing moves to the CPU silently."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    return dev


def to_device(obj, device):
    """A copy of the dataclass ``obj`` with every tensor field on
    ``device`` (fields already there are kept as they are)."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(device)
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})


class SplatFormat(enum.IntEnum):
    MESH2SPLAT = 0      # freshly converted: raw scale, needs *sigma at use
    PLY_3DGS = 1        # imported classic 3DGS PLY: scale already in real units
    COMPRESSED_PBR = 2  # compressed PBR (export-only)
    MESH2SPLAT_ALT = 3  # treated like 0 in shaders


class RenderMode(enum.IntEnum):
    ALBEDO = 0
    DEPTH = 1
    NORMAL = 2
    GEOMETRY = 3
    OVERDRAW = 4
    PBR = 5
    FINAL = 6


@dataclasses.dataclass
class Splats:
    """SoA 3D Gaussian splat model; all tensors share leading dim N and
    ``valid`` masks the live entries."""

    pos: torch.Tensor      # (N, 3) float32 world-space mean
    color: torch.Tensor    # (N, 4) float32 rgb + opacity
    scale: torch.Tensor    # (N, 3) float32 raw scale
    normal: torch.Tensor   # (N, 3) float32 world-space normal
    quat: torch.Tensor     # (N, 4) float32 rotation (w, x, y, z)
    pbr: torch.Tensor      # (N, 2) float32 (metallic, roughness)
    valid: torch.Tensor    # (N,)  bool

    @property
    def capacity(self) -> int:
        return self.pos.shape[0]

    @property
    def device(self) -> torch.device:
        return self.pos.device

    def count(self) -> torch.Tensor:
        return self.valid.sum(dtype=torch.int32)

    def compact(self) -> "Splats":
        """Stable-pack valid splats to the front (static shape)."""
        order = torch.argsort((~self.valid).to(torch.int8), stable=True)
        return Splats(**{f.name: getattr(self, f.name)[order]
                         for f in dataclasses.fields(self)})


# ----------------------------------------------------------------------------
# Codecs: the reference's numeric conventions, encoded once.
# ----------------------------------------------------------------------------

def sigmoid(x):
    return 1.0 / (1.0 + torch.exp(-x))


def inv_sigmoid(alpha):
    alpha = torch.clamp(alpha, 0.0, 1.0)
    return -torch.log(1.0 / (alpha + 1e-8) - 1.0)


def color_to_sh0(color):
    return (color - 0.5) / SH_C0


def sh0_to_color(sh):
    return sh * SH_C0 + 0.5


def encode_normal(n):
    return n * 0.5 + 0.5


def decode_normal(e):
    return e * 2.0 - 1.0


def exponential_depth(view_depth, near, far):
    t = torch.clamp((view_depth - near) / (far - near), 0.0, 1.0)
    return torch.clamp(torch.exp(-20.0 * t), 0.0, 1.0)


def oct_encode(n):
    """Octahedral normal encode to [0,1]^2 with the per-component sign
    (invertible; see mesh2splat_tpu.types.oct_encode for the deviation)."""
    n = n / (n[..., 0:1].abs() + n[..., 1:2].abs() + n[..., 2:3].abs() + 1e-8)
    xy = n[..., :2]
    sign = torch.where(xy >= 0.0, 1.0, -1.0)
    wrapped = (1.0 - xy.flip(-1).abs()) * sign
    res = torch.where(n[..., 2:3] >= 0.0, xy, wrapped)
    return res * 0.5 + 0.5


def oct_decode(e):
    f = e * 2.0 - 1.0
    n = torch.stack(
        [f[..., 0], f[..., 1], 1.0 - f[..., 0].abs() - f[..., 1].abs()], dim=-1
    )
    t = torch.clamp(-n[..., 2:3], 0.0, 1.0)
    xy = n[..., :2] - torch.where(n[..., :2] >= 0.0, t, -t)
    n = torch.cat([xy, n[..., 2:3]], dim=-1)
    return n / (torch.linalg.vector_norm(n, dim=-1, keepdim=True) + 1e-12)


def srgb_to_linear(c):
    return torch.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(c):
    return torch.where(c <= 0.0031308, c * 12.92, 1.055 * c ** (1.0 / 2.4) - 0.055)


# ----------------------------------------------------------------------------
# Camera
# ----------------------------------------------------------------------------

@dataclasses.dataclass
class Camera:
    """GL-convention camera: right-handed view space (camera looks down -Z),
    clip z in [-1, 1]."""

    world_to_view: torch.Tensor  # (4, 4)
    view_to_clip: torch.Tensor   # (4, 4)
    near: float
    far: float
    width: int = 0
    height: int = 0


def look_at(eye, center, up) -> np.ndarray:
    """glm::lookAt (right-handed)."""
    eye = np.asarray(eye, np.float32)
    center = np.asarray(center, np.float32)
    up = np.asarray(up, np.float32)
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


def perspective(fov_y_rad, aspect, near, far) -> np.ndarray:
    """glm::perspective (GL clip z in [-1, 1])."""
    t = 1.0 / np.tan(fov_y_rad / 2.0)
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = t / aspect
    m[1, 1] = t
    m[2, 2] = -(far + near) / (far - near)
    m[2, 3] = -(2.0 * far * near) / (far - near)
    m[3, 2] = -1.0
    return m


def compose_trs(translation=(0, 0, 0), rotation_wxyz=(1, 0, 0, 0),
                scale=(1, 1, 1), device="cuda") -> torch.Tensor:
    """4x4 model-to-world matrix from translate/rotate/scale, quaternion in
    (w, x, y, z)."""
    dev = resolve_device(device)
    t = torch.as_tensor(translation, dtype=torch.float32, device=dev)
    s = torch.as_tensor(scale, dtype=torch.float32, device=dev)
    q = torch.as_tensor(rotation_wxyz, dtype=torch.float32, device=dev)
    q = q / torch.clamp(torch.linalg.vector_norm(q), min=1e-12)
    w, x, y, z = q[0], q[1], q[2], q[3]
    r = torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)]),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)]),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]),
    ])
    m = torch.eye(4, dtype=torch.float32, device=dev)
    m[:3, :3] = r * s[None, :]
    m[:3, 3] = t
    return m


def make_camera(eye, center, up, fov_y_rad, width, height, near=0.1,
                far=100.0, device="cuda") -> Camera:
    """The matrices are built in numpy (as the reference package does) and
    then moved to ``device``."""
    dev = resolve_device(device)
    return Camera(
        world_to_view=torch.from_numpy(look_at(eye, center, up)).to(dev),
        view_to_clip=torch.from_numpy(
            perspective(fov_y_rad, width / height, near, far)).to(dev),
        near=float(np.float32(near)),
        far=float(np.float32(far)),
        width=width,
        height=height,
    )


# ----------------------------------------------------------------------------
# Mesh and material
# ----------------------------------------------------------------------------

@dataclasses.dataclass
class TriangleMesh:
    """World-space triangle soup of one glTF primitive (one material)."""

    tri_pos: torch.Tensor      # (T, 3, 3)
    tri_normal: torch.Tensor   # (T, 3, 3) per-vertex shading normals
    tri_tangent: torch.Tensor  # (T, 3, 4) xyz + handedness w
    tri_uv: torch.Tensor       # (T, 3, 2) texture UVs (UV0)

    def bbox(self):
        flat = self.tri_pos.reshape(-1, 3)
        return flat.amin(dim=0), flat.amax(dim=0)


@dataclasses.dataclass
class Material:
    """Per-primitive material: factors + optional maps (1x1 fallbacks when
    absent; ``has_*`` flags say which maps are real)."""

    base_color_factor: torch.Tensor   # (4,)
    metallic_factor: float
    roughness_factor: float
    base_color: torch.Tensor          # (H, W, 4) in [0,1]
    normal: torch.Tensor              # (H, W, 3) in [0,1] tangent-space map
    metallic_roughness: torch.Tensor  # (H, W, 3); .b = metallic, .g = roughness
    has_base_color: bool = False
    has_normal: bool = False
    has_metallic_roughness: bool = False

    @staticmethod
    def default(device="cuda") -> "Material":
        dev = resolve_device(device)
        return Material(
            base_color_factor=torch.ones((4,), device=dev),
            metallic_factor=1.0,
            roughness_factor=1.0,
            base_color=torch.ones((1, 1, 4), device=dev),
            normal=torch.full((1, 1, 3), 0.5, device=dev),
            metallic_roughness=torch.zeros((1, 1, 3), device=dev),
        )
