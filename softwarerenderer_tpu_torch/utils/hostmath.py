"""Row-vector matrix and quaternion math on the host, in numpy.

The JAX package's ``utils/mathlib.py`` is written once for numpy and
jax.numpy (its ``xp`` keyword); the port's ``utils/mathlib`` holds torch
functions for the frame path.  The host code that the port copies from
the JAX package (the game in ``apps/dust2``, the viewer, ``io_host/ui``,
``io_host/gltf`` and ``io_host/fbx``, and ``models.scene.Camera``) calls
the numpy forms, with the JAX
module's names, so they live here: each function is the JAX module's with
``xp=np``, the same float32 operations in the same order.  The constructors that the port's
``utils/mathlib`` already holds in numpy are re-exported from there.

Nothing here touches torch: the game's per-frame host math (mouse look,
sway and recoil, the move basis, decals, nametags) stays in numpy.
"""

from __future__ import annotations

import numpy as np

from softwarerenderer_tpu_torch.utils import mathlib as _ml
from softwarerenderer_tpu_torch.utils.mathlib import (  # noqa: F401
    QUAT_IDENTITY,
    matrix_from_yaw_pitch_roll,
    quat_from_axis_angle,
    quat_from_yaw_pitch_roll,
    scale,
    translation,
)

F32 = np.float32


def _f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def matrix_from_quaternion(q, xp=np) -> np.ndarray:
    """CreateFromQuaternion in the row-vector layout (the port's
    ``utils.mathlib.matrix_from_quaternion``); `xp` must be numpy, the only
    one the loaders pass."""
    if xp is not np:
        raise ValueError("the port's host matrix_from_quaternion runs on "
                         "numpy only")
    return _ml.matrix_from_quaternion(q)


def dot(a, b) -> np.ndarray:
    return np.sum(_f32(a) * _f32(b), axis=-1)


def cross(a, b) -> np.ndarray:
    a = _f32(a)
    b = _f32(b)
    return np.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], axis=-1)


def length(v) -> np.ndarray:
    return np.sqrt(dot(v, v))


def normalize(v, eps=0.0) -> np.ndarray:
    v = _f32(v)
    n = length(v)
    if eps:
        n = np.where(n < eps, np.ones_like(n), n)
    return v / n[..., None]


def look_at(eye, target, up) -> np.ndarray:
    """Matrix4x4.CreateLookAt (right-handed): zaxis = normalize(eye-target)."""
    eye = _f32(eye)
    zaxis = normalize(eye - _f32(target))
    xaxis = normalize(cross(up, zaxis))
    yaxis = cross(zaxis, xaxis)
    neg = np.stack([-dot(xaxis, eye), -dot(yaxis, eye), -dot(zaxis, eye)])
    one = np.ones((), dtype=np.float32)
    zero = np.zeros((), dtype=np.float32)
    return np.stack([
        np.stack([xaxis[0], yaxis[0], zaxis[0], zero]),
        np.stack([xaxis[1], yaxis[1], zaxis[1], zero]),
        np.stack([xaxis[2], yaxis[2], zaxis[2], zero]),
        np.stack([neg[0], neg[1], neg[2], one]),
    ])


def transform(v, m) -> np.ndarray:
    """Vector4.Transform(v, M) = v·M, summed x, y, z, w in .NET's order."""
    v = _f32(v)
    m = _f32(m)
    return ((v[..., 0:1] * m[..., 0, :] + v[..., 1:2] * m[..., 1, :])
            + v[..., 2:3] * m[..., 2, :]) + v[..., 3:4] * m[..., 3, :]


def transform_normal(n, m) -> np.ndarray:
    """Vector3.TransformNormal(n, M) = n · M[0:3, 0:3] (.NET order)."""
    n = _f32(n)
    m = _f32(m)
    return (n[..., 0:1] * m[..., 0, :3] + n[..., 1:2] * m[..., 1, :3]) \
        + n[..., 2:3] * m[..., 2, :3]


def quat_mul(q1, q2) -> np.ndarray:
    """Hamilton product q1⊗q2 (System.Numerics operator*): q2 applies
    first."""
    q1 = _f32(q1)
    q2 = _f32(q2)
    x1, y1, z1, w1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    x2, y2, z2, w2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return np.stack([
        x1 * w2 + x2 * w1 + (y1 * z2 - z1 * y2),
        y1 * w2 + y2 * w1 + (z1 * x2 - x1 * z2),
        z1 * w2 + z2 * w1 + (x1 * y2 - y1 * x2),
        w1 * w2 - (x1 * x2 + y1 * y2 + z1 * z2),
    ], axis=-1)


def quat_rotate(v, q) -> np.ndarray:
    """Vector3.Transform(v, q): t = 2 (q.xyz × v); v' = v + w·t + q.xyz × t."""
    v = _f32(v)
    q = _f32(q)
    qv = q[..., :3]
    w = q[..., 3:4]
    t = F32(2.0) * cross(qv, v)
    return v + w * t + cross(qv, t)


def quat_slerp(q1, q2, t) -> np.ndarray:
    """Quaternion.Slerp with the .NET lerp fallback for near-parallel quats."""
    q1 = _f32(q1)
    q2 = _f32(q2)
    t = _f32(t)
    cos_omega = np.sum(q1 * q2, axis=-1)
    flip = cos_omega < 0
    cos_omega = np.abs(cos_omega)
    use_lerp = cos_omega > F32(1.0 - 1e-6)
    omega = np.arccos(np.clip(cos_omega, -1.0, 1.0))
    inv_sin = F32(1.0) / np.where(use_lerp, F32(1.0), np.sin(omega))
    s1 = np.where(use_lerp, F32(1.0) - t,
                  np.sin((F32(1.0) - t) * omega) * inv_sin)
    s2 = np.where(use_lerp, t, np.sin(t * omega) * inv_sin)
    s2 = np.where(flip, -s2, s2)
    return q1 * s1[..., None] + q2 * s2[..., None]


def quat_to_euler_degrees(q) -> np.ndarray:
    """Camera.GetEulerAngles (Camera.cs:33-61): (pitch_x, yaw_y, roll_z) in
    degrees."""
    q = _f32(q)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    two = F32(2.0)
    one = F32(1.0)
    sinr_cosp = two * (w * z + x * y)
    cosr_cosp = one - two * (z * z + x * x)
    roll = np.arctan2(sinr_cosp, cosr_cosp)
    sinp = two * (w * x - y * z)
    pitch = np.where(np.abs(sinp) >= one, np.sign(sinp) * F32(np.pi / 2),
                     np.arcsin(np.clip(sinp, -1.0, 1.0)))
    siny_cosp = two * (w * y + z * x)
    cosy_cosp = one - two * (x * x + y * y)
    yaw = np.arctan2(siny_cosp, cosy_cosp)
    rad2deg = F32(180.0 / np.pi)
    return np.stack([pitch * rad2deg, yaw * rad2deg, roll * rad2deg],
                    axis=-1)


def euler_degrees_to_direction(euler_degrees) -> np.ndarray:
    """Renderer.EulerToDirection (Renderer.cs:967-972): -UnitZ rotated by
    CreateFromYawPitchRoll(yawY, pitchX, rollZ), normalized."""
    e = _f32(euler_degrees) * F32(np.pi / 180.0)
    m = matrix_from_yaw_pitch_roll(e[1], e[0], e[2])
    d = transform_normal(np.asarray([0.0, 0.0, -1.0], dtype=np.float32), m)
    return normalize(d)
