"""Per-pixel view rays.

Counterpart of ``pixel_ray_directions`` in
``softwarerenderer_tpu/ops/sky.py``.  Its ``sample_panorama`` (the
equirectangular sky background) is not ported yet: a ``sky_panorama``
uniform raises ``NotImplementedError`` on every route of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from softwarerenderer_tpu_torch.utils import mathlib as ml

F32 = np.float32


def pixel_ray_directions(uniforms, width: int, height: int,
                         device) -> torch.Tensor:
    """World-space view ray direction per pixel, (H, W, 3) float32 on
    `device`, matching the raster projection: pixel centres at integer
    coordinates, Y-down screen to Y-up NDC, the vertical FOV of the .NET
    perspective.

    The camera basis, the half extents and the W + H screen coordinates are
    computed on the host and uploaded in one copy; only the (H, W) combine
    and the normalization run on the device, whose divisor is a device
    tensor (CUDA divides by a host scalar as a multiply by its reciprocal,
    which is not x / W in every bit)."""
    rot = torch.from_numpy(np.asarray(uniforms["camera_rotation"], F32))
    front = ml.quat_rotate(torch.tensor([0.0, 0.0, -1.0]), rot)
    up = ml.quat_rotate(torch.tensor([0.0, 1.0, 0.0]), rot)
    right = ml.cross(front, up)
    fov = torch.from_numpy(np.asarray(uniforms["fov_degrees"], F32)) \
        * float(F32(np.pi / 180.0))
    th = torch.tan(fov * 0.5)
    tw = th * float(F32(width / height))
    xs = np.arange(width, dtype=F32) / F32(width) * F32(2.0) - F32(1.0)
    ys = F32(1.0) - np.arange(height, dtype=F32) / F32(height) * F32(2.0)
    packed = torch.cat([front, up, right, th.reshape(1), tw.reshape(1),
                        torch.from_numpy(xs), torch.from_numpy(ys)]).to(device)
    front, up, right = packed[0:3], packed[3:6], packed[6:9]
    th, tw = packed[9], packed[10]
    xs, ys = packed[11:11 + width], packed[11 + width:]
    d = (front + (xs * tw)[None, :, None] * right) \
        + (ys * th)[:, None, None] * up
    return d / torch.sqrt(torch.clamp(ml.dot(d, d), min=1e-30))[..., None]
