"""Player fly-camera controller — pure-functional ``Player_UpdateLocal``.

A copy of ``rl_ode_physics_tpu/models/player.py`` (numpy only), kept in the
port so that it imports nothing of the JAX package.

Reimplements the reference's controller (``src/player.c:10-54``) as a pure
function of (state, input, dt): WASD+QE movement in the camera frame, IJKL
look, left-shift ramping acceleration (``mult += dt; moveSpeed += mult*10``),
pitch clamped to ±89° (``MAX_PITCH``, ``src/player.c:3``), F toggling fovy
90↔40. The reference keeps yaw/pitch/mult in C statics; here they live in
``PlayerState`` so multiple players update side by side (and vmap over a
roster works).
"""

from __future__ import annotations

import dataclasses

import numpy as np

MAX_PITCH = np.deg2rad(89.0)     # src/player.c:3


@dataclasses.dataclass
class PlayerInput:
    w: bool = False
    s: bool = False
    a: bool = False
    d: bool = False
    q: bool = False
    e: bool = False
    i: bool = False
    k: bool = False
    j: bool = False
    l: bool = False
    shift: bool = False
    zoom: bool = False           # F key


@dataclasses.dataclass
class PlayerCamera:
    pos: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 2.0, -3.0]))  # src/player.c:8
    yaw: float = 0.0
    pitch: float = 0.0
    mult: float = 1.0
    fovy: float = 90.0
    up: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 1.0, 0.0]))

    @property
    def forward(self) -> np.ndarray:
        f = np.array([
            np.cos(self.pitch) * np.sin(self.yaw),
            np.sin(self.pitch),
            np.cos(self.pitch) * np.cos(self.yaw),
        ])
        return f / np.linalg.norm(f)

    @property
    def target(self) -> np.ndarray:
        return self.pos + self.forward


def update_local(cam: PlayerCamera, inp: PlayerInput,
                 move_speed: float = 2.0, turn_speed: float = 2.0,
                 dt: float = 1.0 / 60.0) -> PlayerCamera:
    """One frame of the reference controller (called with (2, 2, dt) at
    ``src/main.c:476``). Returns a new PlayerCamera."""
    cam = dataclasses.replace(cam)

    # shift acceleration ramp (src/player.c:11-17)
    if inp.shift:
        cam.mult = cam.mult + dt
        move_speed = move_speed + cam.mult * 10.0
    else:
        cam.mult = 1.0

    movement = np.zeros(3)
    if inp.w:
        movement[2] += move_speed * dt
    if inp.s:
        movement[2] -= move_speed * dt
    if inp.a:
        movement[0] += move_speed * dt
    if inp.d:
        movement[0] -= move_speed * dt
    if inp.q:
        movement[1] -= move_speed * dt
    if inp.e:
        movement[1] += move_speed * dt

    if inp.i:
        cam.pitch += turn_speed * dt
    if inp.k:
        cam.pitch -= turn_speed * dt
    if inp.j:
        cam.yaw += turn_speed * dt
    if inp.l:
        cam.yaw -= turn_speed * dt
    cam.pitch = float(np.clip(cam.pitch, -MAX_PITCH, MAX_PITCH))
    cam.fovy = 40.0 if inp.zoom else 90.0     # src/player.c:36

    forward = cam.forward
    right = np.cross(cam.up, forward)
    right = right / np.linalg.norm(right)

    cam.pos = cam.pos + forward * movement[2] + right * movement[0]
    cam.pos[1] += movement[1]
    return cam
