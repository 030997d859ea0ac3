"""Row-vector matrix / quaternion math in the reference's conventions.

Counterpart of ``softwarerenderer_tpu/utils/mathlib.py`` for the functions the
frame path uses.  Every formula keeps the JAX module's float32 operation
order (explicit left-to-right multiply-adds, never ``matmul``), so results
agree with it and with .NET System.Numerics to the last rounding wherever
neither side contracts a multiply-add.  All functions run on whatever device
their tensor arguments live on.

Matrices transform ROW vectors: ``transform(v, M) == v @ M``.
"""

from __future__ import annotations

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
