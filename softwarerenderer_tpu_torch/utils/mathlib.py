"""Row-vector matrix / quaternion math in the reference's conventions.

Counterpart of ``softwarerenderer_tpu/utils/mathlib.py`` for the functions the
port uses, in two parts:

  * torch functions for the frame path (``dot`` ... ``perspective_fov``,
    ``invert``, ``safe_normalize``).  Every formula keeps the JAX module's
    float32 operation order (explicit left-to-right multiply-adds, never
    ``matmul``), so results agree with it and with .NET System.Numerics to
    the last rounding wherever neither side contracts a multiply-add.  They
    run on whatever device their tensor arguments live on.
  * numpy host constructors for building scenes and cameras
    (``translation``, ``matrix_from_quaternion``,
    ``matrix_from_yaw_pitch_roll``, ``quat_from_yaw_pitch_roll``,
    ``QUAT_IDENTITY``), copied from the JAX module's numpy path.

Matrices transform ROW vectors: ``transform(v, M) == v @ M``.
"""

from __future__ import annotations

import numpy as np
import torch

F32 = torch.float32


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis of a * b, summed left to right."""
    p = a * b
    out = p[..., 0]
    for k in range(1, p.shape[-1]):
        out = out + p[..., k]
    return out


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def normalize(v: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    n = torch.sqrt(dot(v, v))
    if eps:
        n = torch.where(n < eps, torch.ones_like(n), n)
    return v / n[..., None]


def transform(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Vector4.Transform(v, M) = v·M as x·M[0] + y·M[1] + z·M[2] + w·M[3];
    batched matrices broadcast against v's leading dims."""
    return ((v[..., 0:1] * m[..., 0, :] + v[..., 1:2] * m[..., 1, :])
            + v[..., 2:3] * m[..., 2, :]) + v[..., 3:4] * m[..., 3, :]


def transform_point(p: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Vector3.Transform(p, M): (p, 1)·M, xyz (affine M, no divide)."""
    return ((p[..., 0:1] * m[..., 0, :3] + p[..., 1:2] * m[..., 1, :3])
            + p[..., 2:3] * m[..., 2, :3]) + m[..., 3, :3]


def transform_normal(n: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Vector3.TransformNormal(n, M) = n · M[0:3, 0:3]."""
    return (n[..., 0:1] * m[..., 0, :3] + n[..., 1:2] * m[..., 1, :3]) \
        + n[..., 2:3] * m[..., 2, :3]


def homogenize(p: torch.Tensor) -> torch.Tensor:
    """(..., 3) points -> (..., 4) with w = 1."""
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def quat_rotate(v: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Vector3.Transform(v, q): t = 2 (q.xyz × v); v' = v + w·t + q.xyz × t."""
    qv = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * cross(qv, v)
    return v + w * t + cross(qv, t)


def look_at(eye: torch.Tensor, target: torch.Tensor,
            up: torch.Tensor) -> torch.Tensor:
    """Matrix4x4.CreateLookAt (right-handed): zaxis = normalize(eye-target)."""
    zaxis = normalize(eye - target)
    xaxis = normalize(cross(up, zaxis))
    yaxis = cross(zaxis, xaxis)
    zero = torch.zeros((), dtype=F32, device=eye.device)
    one = torch.ones((), dtype=F32, device=eye.device)
    return torch.stack([
        torch.stack([xaxis[0], yaxis[0], zaxis[0], zero]),
        torch.stack([xaxis[1], yaxis[1], zaxis[1], zero]),
        torch.stack([xaxis[2], yaxis[2], zaxis[2], zero]),
        torch.stack([-dot(xaxis, eye), -dot(yaxis, eye), -dot(zaxis, eye),
                     one]),
    ])


def perspective_fov(fov_radians: torch.Tensor, aspect: torch.Tensor,
                    near: torch.Tensor, far: torch.Tensor) -> torch.Tensor:
    """Matrix4x4.CreatePerspectiveFieldOfView: row-vector RH projection
    (ndcZ 0 at `near`, 1 at `far`; w_clip = view-space depth).  Every
    argument is a 0-d float32 tensor."""
    y_scale = 1.0 / torch.tan(fov_radians * 0.5)
    x_scale = y_scale / aspect
    neg_far_range = far / (near - far)
    zero = torch.zeros_like(y_scale)
    one = torch.ones_like(y_scale)
    return torch.stack([
        torch.stack([x_scale, zero, zero, zero]),
        torch.stack([zero, y_scale, zero, zero]),
        torch.stack([zero, zero, neg_far_range, -one]),
        torch.stack([zero, zero, near * neg_far_range, zero]),
    ])


def safe_normalize(v: torch.Tensor) -> torch.Tensor:
    """Normalize; zero vectors stay zero (no NaN)."""
    sq = dot(v, v)
    pos = sq > 0
    inv = torch.where(pos, 1.0 / torch.sqrt(torch.where(pos, sq, 1.0)), 0.0)
    return v * inv[..., None]


def invert(m: torch.Tensor):
    """General 4x4 inverse by cofactor expansion (Matrix4x4.Invert), over
    leading batch dimensions.  Returns (inv, ok); ok is False where
    |det| <= 1e-12, and inv is zero there."""
    a, b, c, d = (m[..., 0, k] for k in range(4))
    e, f, g, h = (m[..., 1, k] for k in range(4))
    i, j, k, l = (m[..., 2, q] for q in range(4))
    mm, n, o, p = (m[..., 3, q] for q in range(4))

    kp_lo = k * p - l * o
    jp_ln = j * p - l * n
    jo_kn = j * o - k * n
    ip_lm = i * p - l * mm
    io_km = i * o - k * mm
    in_jm = i * n - j * mm

    a11 = f * kp_lo - g * jp_ln + h * jo_kn
    a12 = -(e * kp_lo - g * ip_lm + h * io_km)
    a13 = e * jp_ln - f * ip_lm + h * in_jm
    a14 = -(e * jo_kn - f * io_km + g * in_jm)

    det = a * a11 + b * a12 + c * a13 + d * a14
    ok = det.abs() > 1e-12
    safe_det = torch.where(ok, det, 1.0)
    inv_det = torch.where(ok, 1.0 / safe_det, 0.0)

    gp_ho = g * p - h * o
    fp_hn = f * p - h * n
    fo_gn = f * o - g * n
    ep_hm = e * p - h * mm
    eo_gm = e * o - g * mm
    en_fm = e * n - f * mm

    gl_hk = g * l - h * k
    fl_hj = f * l - h * j
    fk_gj = f * k - g * j
    el_hi = e * l - h * i
    ek_gi = e * k - g * i
    ej_fi = e * j - f * i

    out = torch.stack([
        torch.stack([a11, -(b * kp_lo - c * jp_ln + d * jo_kn),
                     b * gp_ho - c * fp_hn + d * fo_gn,
                     -(b * gl_hk - c * fl_hj + d * fk_gj)], -1),
        torch.stack([a12, a * kp_lo - c * ip_lm + d * io_km,
                     -(a * gp_ho - c * ep_hm + d * eo_gm),
                     a * gl_hk - c * el_hi + d * ek_gi], -1),
        torch.stack([a13, -(a * jp_ln - b * ip_lm + d * in_jm),
                     a * fp_hn - b * ep_hm + d * en_fm,
                     -(a * fl_hj - b * el_hi + d * ej_fi)], -1),
        torch.stack([a14, a * jo_kn - b * io_km + c * in_jm,
                     -(a * fo_gn - b * eo_gm + c * en_fm),
                     a * fk_gj - b * ek_gi + c * ej_fi], -1),
    ], -2)
    return out * inv_det[..., None, None], ok


# ---------------------------------------------------------------------------
# Host constructors (numpy), copied from the JAX module's numpy path
# ---------------------------------------------------------------------------

QUAT_IDENTITY = np.array([0.0, 0.0, 0.0, 1.0], dtype=np.float32)


def translation(t) -> np.ndarray:
    """CreateTranslation: translation lives in the last row (row-vector)."""
    m = np.eye(4, dtype=np.float32)
    m[3, :3] = np.asarray(t, dtype=np.float32)
    return m


def matrix_from_quaternion(q) -> np.ndarray:
    """CreateFromQuaternion in the row-vector layout:
    M11=1-2(y²+z²) M12=2(xy+wz) M13=2(xz-wy), etc."""
    q = np.asarray(q, dtype=np.float32)
    x, y, z, w = q[0], q[1], q[2], q[3]
    two = np.float32(2.0)
    one = np.ones((), dtype=np.float32)
    zero = np.zeros((), dtype=np.float32)
    return np.stack([
        np.stack([one - two * (y * y + z * z), two * (x * y + w * z),
                  two * (x * z - w * y), zero]),
        np.stack([two * (x * y - w * z), one - two * (x * x + z * z),
                  two * (y * z + w * x), zero]),
        np.stack([two * (x * z + w * y), two * (y * z - w * x),
                  one - two * (x * x + y * y), zero]),
        np.stack([zero, zero, zero, one]),
    ])


def quat_from_yaw_pitch_roll(yaw, pitch, roll) -> np.ndarray:
    """Quaternion.CreateFromYawPitchRoll (yaw about Y, pitch about X, roll
    about Z)."""
    half_y = np.asarray(yaw, np.float32) * np.float32(0.5)
    half_p = np.asarray(pitch, np.float32) * np.float32(0.5)
    half_r = np.asarray(roll, np.float32) * np.float32(0.5)
    sy, cy = np.sin(half_y), np.cos(half_y)
    sp, cp = np.sin(half_p), np.cos(half_p)
    sr, cr = np.sin(half_r), np.cos(half_r)
    return np.stack([
        cy * sp * cr + sy * cp * sr,
        sy * cp * cr - cy * sp * sr,
        cy * cp * sr - sy * sp * cr,
        cy * cp * cr + sy * sp * sr,
    ], axis=-1)


def matrix_from_yaw_pitch_roll(yaw, pitch, roll) -> np.ndarray:
    """CreateFromYawPitchRoll = CreateFromQuaternion(quat_from_yaw_pitch_roll)."""
    return matrix_from_quaternion(quat_from_yaw_pitch_roll(yaw, pitch, roll))
