"""Plain reference of the image-quality frame's last stages: the winner's
depth, the equirect sky, SSAO, bloom, the ACES tone map, FXAA and the
ssaa box resolve, over (H, W, 4) colour and (H, W) depth.

Written from the renderer's stated semantics, with nothing of the program
imported.  Where a stage departs from its published description, the
renderer's semantics are the ones written here:

  * depth: the winner's screen-space interpolation of its corners'
    (ndc z + 1) / 2 with the signed weights e_i / area, so a front face
    stores the negated value (larger is nearer);
  * sky: a pixel no triangle covered takes the panorama along its view
    ray, pixel centres at whole coordinates (x / W . 2 - 1, 1 - y / H .
    2), u = 0.5 + atan2(x, -z) / 2 pi, v = 0.5 - asin(y) / pi, bilinear
    with repeat in both axes (also across the poles);
  * SSAO: no random kernel and no normals: the linear view distance
    against edge-clamped neighbours at fixed offsets (four direction
    pairs at radii 1, 2, 4), a pair occluding only when both sides are
    nearer by more than 0.2 % of the distance, ramped over 2 % of it and
    faded back out past a full ramp; 2 x the mean over the 12 pairs,
    covered pixels darkened by 0.9 . ao;
  * bloom: bright pass max(rgb - 0.8, 0), then a [1, 2, 1] / 4 blur down
    the columns and then along the rows at dilations 1, 2 and 4 (edge
    clamped), added at strength 0.7 and clipped to [0, 1];
  * ACES: Narkowicz's fit of max(rgb, 0) (exposure 1), clipped to [0, 1];
  * FXAA: FXAA 3.11's detection and subpixel blend without the edge
    search (the renderer's preset): Rec.601 luma, a pixel whose
    4-neighbourhood contrast reaches max(1/24, luma_max / 8) blends
    toward the mean of its two neighbours across the edge (the larger
    second difference picks the axis) by the smoothstep of its distance
    from the cross mean over the contrast, squared and capped at 0.75;
  * resolve: the mean of each f x f block of colour.

Every float is computed in the input's dtype (float32 as the renderer
states; bfloat16 for the control).  Alpha passes every stage unchanged.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from portbench.reference.raster import _cross, _dot, _edges
from portbench.reference.texture import Mips


def winner_depth(g: Dict, win: torch.Tensor):
    """(H, W) depth of each pixel's winner (0 where none) and the (H, W)
    mask of covered pixels."""
    height, width = win.shape
    flat = win.reshape(-1)
    covered = flat >= 0
    pix = torch.nonzero(covered).squeeze(1)
    r = flat[pix]
    dt = g["screen"].dtype
    e = _edges(g["screen"][r], (pix % width).to(dt), (pix // width).to(dt))
    ia, dv = g["inv_area"][r], g["depth"][r]
    d = dv[:, 0] * (e[0] * ia) + dv[:, 1] * (e[1] * ia) \
        + dv[:, 2] * (e[2] * ia)
    out = torch.zeros(height * width, dtype=dt, device=win.device)
    out[pix] = d
    return out.reshape(height, width), covered.reshape(height, width)


def _c(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32)).to(
        device=like.device, dtype=like.dtype)


def view_rays(cam: Dict, width: int, height: int, dt, device):
    """(H, W, 3) unit view directions, pixel centres at whole
    coordinates, the vertical field of view the projection uses."""
    q = torch.as_tensor(np.asarray(cam["rotation"], np.float32)).to(dt)

    def rotate(v):
        v = torch.tensor(v, dtype=dt)
        tt = 2.0 * _cross(q[:3], v)
        return v + q[3] * tt + _cross(q[:3], tt)
    front = rotate([0.0, 0.0, -1.0])
    up = rotate([0.0, 1.0, 0.0])
    right = _cross(front, up)
    fov = torch.as_tensor(np.float32(cam["fov_degrees"])).to(dt) \
        * float(np.float32(np.pi / 180.0))
    th = torch.tan(fov * 0.5)
    tw = th * float(np.float32(width / height))
    xs = torch.arange(width, dtype=dt) / float(width) * 2.0 - 1.0
    ys = 1.0 - torch.arange(height, dtype=dt) / float(height) * 2.0
    front, up, right, th, tw, xs, ys = (
        t.to(device) for t in (front, up, right, th, tw, xs, ys))
    d = (front + (xs * tw)[None, :, None] * right) \
        + (ys * th)[:, None, None] * up
    n = torch.sqrt(_dot(d, d).clamp(min=1e-30))
    return d / n[..., None]


def sky(color: torch.Tensor, covered: torch.Tensor, cam: Dict,
        panorama: torch.Tensor) -> torch.Tensor:
    """The panorama (an (h, w, 4) uint8 tensor) on every uncovered
    pixel."""
    height, width = covered.shape
    dt = color.dtype
    d = view_rays(cam, width, height, dt, color.device)
    u = 0.5 + torch.atan2(d[..., 0], -d[..., 2]) \
        * float(np.float32(1.0 / (2.0 * np.pi)))
    v = 0.5 - torch.asin(d[..., 1].clamp(-1.0, 1.0)) \
        * float(np.float32(1.0 / np.pi))
    pano = Mips([[panorama]], color.device)
    zero = torch.zeros(height * width, dtype=torch.int64,
                       device=color.device)
    s = pano.bilinear(zero, zero, torch.stack([u, v], -1).reshape(-1, 2))
    return torch.where(covered[..., None], color,
                       s.reshape(height, width, 4))


def _clamped(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[y, x] = a[clamp(y + dy), clamp(x + dx)]."""
    h, w = a.shape[0], a.shape[1]
    ys = (torch.arange(h, device=a.device) + dy).clamp(0, h - 1)
    xs = (torch.arange(w, device=a.device) + dx).clamp(0, w - 1)
    return a.index_select(0, ys).index_select(1, xs)


PAIRS = ((1, 0), (0, 1), (1, 1), (1, -1))


def linear_distance(depth: torch.Tensor, covered: torch.Tensor,
                    near, far) -> torch.Tensor:
    """View distance from the stored depth, in [near, far]; far where
    nothing is covered."""
    ndc = -2.0 * torch.where(covered, depth, torch.full_like(depth, -0.5)) \
        - 1.0
    den = far + ndc * (near - far)
    d = far * near / torch.where(den == 0, torch.full_like(den, 1e-9), den)
    return torch.where(covered, d.clamp(min=near).clamp(max=far),
                       far.expand_as(d))


def ssao(color: torch.Tensor, depth: torch.Tensor, covered: torch.Tensor,
         near, far) -> torch.Tensor:
    near, far = _c(near, color), _c(far, color)
    d = linear_distance(depth, covered, near, far)
    ao = torch.zeros_like(d)
    n = 0
    for r in (1, 2, 4):
        ramp = d * float(np.float32(0.02)) * float(r)
        bias = d * float(np.float32(0.002))
        for dy, dx in PAIRS:
            gap = torch.minimum(d - _clamped(d, dy * r, dx * r),
                                d - _clamped(d, -dy * r, -dx * r))
            occ = ((gap - bias) / ramp.clamp(min=1e-6)).clamp(0.0, 1.0)
            ao = ao + occ * (2.0 - occ).clamp(0.0, 1.0)
            n += 1
    ao = (ao * 2.0 / torch.full((), float(n), dtype=d.dtype,
                                device=d.device)).clamp(0.0, 1.0)
    shade = torch.where(covered, 1.0 - float(np.float32(0.9)) * ao,
                        torch.ones_like(ao))
    return torch.cat([color[..., :3] * shade[..., None], color[..., 3:]], -1)


def bloom(color: torch.Tensor) -> torch.Tensor:
    b = (color[..., :3] - 0.8).clamp(min=0.0)
    for k in (1, 2, 4):
        b = (_clamped(b, -k, 0) + b + b + _clamped(b, k, 0)) * 0.25
        b = (_clamped(b, 0, -k) + b + b + _clamped(b, 0, k)) * 0.25
    rgb = (color[..., :3] + 0.7 * b).clamp(0.0, 1.0)
    return torch.cat([rgb, color[..., 3:]], -1)


def aces(color: torch.Tensor) -> torch.Tensor:
    x = color[..., :3].clamp(min=0.0)
    y = ((x * (2.51 * x + 0.03)) / (x * (2.43 * x + 0.59) + 0.14))
    return torch.cat([y.clamp(0.0, 1.0), color[..., 3:]], -1)


def _luma(rgb: torch.Tensor) -> torch.Tensor:
    return (rgb[..., 0] * float(np.float32(0.299))
            + rgb[..., 1] * float(np.float32(0.587))
            + rgb[..., 2] * float(np.float32(0.114)))


def fxaa(color: torch.Tensor) -> torch.Tensor:
    rgb = color[..., :3]
    c = _luma(rgb)
    n, s = _clamped(c, -1, 0), _clamped(c, 1, 0)
    e, w = _clamped(c, 0, 1), _clamped(c, 0, -1)
    hi = torch.stack([c, n, s, e, w]).amax(0)
    lo = torch.stack([c, n, s, e, w]).amin(0)
    contrast = hi - lo
    edge = contrast >= (hi * float(np.float32(1.0 / 8.0))).clamp(
        min=float(np.float32(1.0 / 24.0)))
    t = ((n + s + e + w) * 0.25 - c).abs() / contrast.clamp(min=1e-6)
    t = t.clamp(0.0, 1.0)
    t = t * t * (3.0 - 2.0 * t)
    t = (t * t).clamp(max=float(np.float32(0.75)))
    across_rows = (n + s - c - c).abs() >= (e + w - c - c).abs()
    mean = torch.where(across_rows[..., None],
                       (_clamped(rgb, -1, 0) + _clamped(rgb, 1, 0)) * 0.5,
                       (_clamped(rgb, 0, 1) + _clamped(rgb, 0, -1)) * 0.5)
    t = torch.where(edge, t, torch.zeros_like(t))[..., None]
    return torch.cat([rgb + (mean - rgb) * t, color[..., 3:]], -1)


def resolve(color: torch.Tensor, f: int) -> torch.Tensor:
    """(H / f, W / f, 4): the mean of each f x f block."""
    h, w = color.shape[0] // f, color.shape[1] // f
    blocks = color.reshape(h, f, w, f, color.shape[-1])
    return blocks.sum((1, 3)) / torch.full((), float(f * f),
                                            dtype=color.dtype,
                                            device=color.device)
