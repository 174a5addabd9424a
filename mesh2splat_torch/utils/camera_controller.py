"""Interactive-style camera controller (counterpart of
``mesh2splat_tpu.utils.camera_controller``, the same numpy math): the
pure-math core of the reference's IoHandler + Camera (reference: src/renderer/IoHandler.cpp:24-65,
src/utils/Camera.cpp:22-93) without the GLFW event loop.

WASD/QE fly movement, mouse-look yaw/pitch, R/T roll, scroll-to-FOV — each
update is a pure function of (state, input), so a notebook/CLI/remote viewer
can drive frames through ``render_frame`` deterministically.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..types import Camera, make_camera


@dataclasses.dataclass
class FlyCamera:
    """Mutable camera state (host-side; converts to a Camera of tensors)."""

    position: np.ndarray
    yaw_deg: float = -90.0      # reference Camera defaults (Camera.hpp)
    pitch_deg: float = 0.0
    roll_deg: float = 0.0
    fov_deg: float = 60.0
    speed: float = 2.5          # units/s, shift x4 / ctrl /4 (IoHandler.cpp:33-38)
    sensitivity: float = 0.1    # degrees per pixel (Camera.cpp:52)

    @staticmethod
    def create(position=(0.0, 0.0, 3.0)) -> "FlyCamera":
        return FlyCamera(position=np.asarray(position, np.float64))

    # ------------------------------------------------------------ basis
    def basis(self):
        """(front, right, up) unit vectors incl. roll (Camera.cpp:76-93)."""
        cy, sy = np.cos(np.deg2rad(self.yaw_deg)), np.sin(np.deg2rad(self.yaw_deg))
        cp, sp = np.cos(np.deg2rad(self.pitch_deg)), np.sin(np.deg2rad(self.pitch_deg))
        front = np.asarray([cy * cp, sp, sy * cp])
        front /= np.linalg.norm(front)
        world_up = np.asarray([0.0, 1.0, 0.0])
        right = np.cross(front, world_up)
        right /= np.linalg.norm(right) + 1e-12
        up = np.cross(right, front)
        cr, sr = np.cos(np.deg2rad(self.roll_deg)), np.sin(np.deg2rad(self.roll_deg))
        right, up = cr * right + sr * up, -sr * right + cr * up
        return front, right, up

    # ------------------------------------------------------------ inputs
    def move(self, dt: float, forward=0.0, strafe=0.0, lift=0.0,
             fast=False, slow=False):
        """WASD/QE movement (IoHandler.cpp:24-49)."""
        v = self.speed * (4.0 if fast else 0.25 if slow else 1.0) * dt
        front, right, up = self.basis()
        self.position = (
            self.position + front * (forward * v) + right * (strafe * v)
            + up * (lift * v)
        )
        return self

    def look(self, dx_px: float, dy_px: float):
        """Mouse-look, RMB-drag semantics (Camera.cpp:44-63): pitch clamped
        to +-89 degrees."""
        self.yaw_deg += dx_px * self.sensitivity
        self.pitch_deg = float(
            np.clip(self.pitch_deg - dy_px * self.sensitivity, -89.0, 89.0)
        )
        return self

    def roll(self, degrees: float):
        """R/T roll keys (IoHandler.cpp:51-56)."""
        self.roll_deg += degrees
        return self

    def zoom(self, scroll: float):
        """Scroll-to-FOV, clamped to [1, 90] (Camera.cpp:65-74)."""
        self.fov_deg = float(np.clip(self.fov_deg - scroll, 1.0, 90.0))
        return self

    # ------------------------------------------------------------ export
    def camera(self, width: int, height: int, device="cuda") -> Camera:
        front, right, up = self.basis()
        return make_camera(
            eye=list(self.position),
            center=list(self.position + front),
            up=list(up),
            fov_y_rad=float(np.deg2rad(self.fov_deg)),
            width=width,
            height=height,
            device=device,
        )
