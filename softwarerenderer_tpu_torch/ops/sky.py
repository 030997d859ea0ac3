"""Per-pixel view rays and the equirectangular sky.

Counterpart of ``softwarerenderer_tpu/ops/sky.py``:
``pixel_ray_directions``, ``sample_panorama`` (a bilinear lat-long lookup
by direction), ``composite_sky`` (the panorama on every pixel the frame
left at clear depth, the "sky" stage of the post chain: on the card one
kernel, ``ops/post_kernels.sky``, whose plain twin is
``composite_sky_plain``) and
``irradiance_panorama``, the host (numpy) cosine convolution that makes
PBR's ``env_irradiance`` map, copied from the JAX module.  A panorama is
an (H, W, 4) float32 or uint8 array.
"""

from __future__ import annotations

import numpy as np
import torch

from softwarerenderer_tpu_torch.ops import post_kernels, texture
from softwarerenderer_tpu_torch.ops.raster import DEPTH_CLEAR
from softwarerenderer_tpu_torch.utils import mathlib as ml
from softwarerenderer_tpu_torch.utils.staging import upload

F32 = np.float32


def ray_basis(uniforms, width: int, height: int, device) -> torch.Tensor:
    """What pixel_ray_directions combines, (11 + W + H,) float32 on
    `device`: the camera's front, up and right, the half extents th and
    tw, then the W + H screen coordinates xs and ys (pixel centres at
    integer coordinates, Y-down screen to Y-up NDC, the vertical FOV of
    the .NET perspective).  Computed on the host and uploaded in one
    pinned copy that does not wait for the card (utils.staging.upload)."""
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
                        torch.from_numpy(xs), torch.from_numpy(ys)])
    return upload(packed.numpy(), device)


def pixel_ray_directions(uniforms, width: int, height: int,
                         device) -> torch.Tensor:
    """World-space view ray direction per pixel, (H, W, 3) float32 on
    `device`: ray_basis's (H, W) combine and normalization, on the device,
    whose divisor is a device tensor (CUDA divides by a host scalar as a
    multiply by its reciprocal, which is not x / W in every bit)."""
    packed = ray_basis(uniforms, width, height, device)
    front, up, right = packed[0:3], packed[3:6], packed[6:9]
    th, tw = packed[9], packed[10]
    xs, ys = packed[11:11 + width], packed[11 + width:]
    d = (front + (xs * tw)[None, :, None] * right) \
        + (ys * th)[:, None, None] * up
    return d / torch.sqrt(torch.clamp(ml.dot(d, d), min=1e-30))[..., None]


def sample_panorama(panorama: torch.Tensor,
                    directions: torch.Tensor) -> torch.Tensor:
    """Bilinear lat-long lookup of (..., 3) directions: u from atan2
    around +y (u = 0.5 faces -z), v from the elevation (v = 0 at +y).
    panorama: (H, W, 4) float32 or uint8 on the directions' device."""
    d = directions.to(torch.float32)
    u = 0.5 + torch.atan2(d[..., 0], -d[..., 2]) \
        * float(F32(1.0 / (2.0 * np.pi)))
    v = 0.5 - torch.asin(d[..., 1].clamp(-1.0, 1.0)) * float(F32(1.0 / np.pi))
    h, w = panorama.shape[0], panorama.shape[1]
    zeros = torch.zeros(u.shape, dtype=torch.int32, device=u.device)
    return texture.sample_atlas_region_bilinear(
        panorama, zeros, zeros, zeros + h, zeros + w,
        torch.stack([u, v], dim=-1))


def composite_sky(color: torch.Tensor, depth: torch.Tensor, uniforms,
                  panorama: torch.Tensor):
    """(color, depth) with every clear-depth pixel replaced by the
    panorama's sample along its view ray (alpha 1 from the panorama);
    the camera comes from the host `uniforms`.  CUDA tensors launch
    csrc/post_fx.cu's sky kernel (ops/post_kernels.sky), CPU tensors run
    composite_sky_plain."""
    if not depth.is_cuda:
        return composite_sky_plain(color, depth, uniforms, panorama)
    H, W = depth.shape
    rays = ray_basis(uniforms, W, H, device=depth.device)
    return post_kernels.sky(color, depth, rays, panorama), depth


def composite_sky_plain(color: torch.Tensor, depth: torch.Tensor, uniforms,
                        panorama: torch.Tensor):
    """composite_sky in plain PyTorch, the sky kernel's twin."""
    H, W = depth.shape
    dirs = pixel_ray_directions(uniforms, W, H, device=depth.device)
    sky = sample_panorama(panorama, dirs)
    return torch.where((depth == DEPTH_CLEAR)[..., None], sky, color), depth


def irradiance_panorama(panorama, out_h: int = 16) -> np.ndarray:
    """Cosine-convolved (diffuse) irradiance map of an equirect panorama,
    host-side, run once at scene setup (numpy only): a small (out_h,
    2·out_h, 4) lat-long map whose entry (v, u) is the cosine-weighted
    average of the environment over the hemisphere around that direction.
    Sample it by the surface normal for image-based diffuse ambient
    (uniforms["env_irradiance"], ops.lighting.pbr_scene_fragment_shader).

    Copied from the JAX package's numpy function, the same operations in
    the same order (tests/test_torch_package.py holds it to its source)."""
    pano = np.asarray(panorama, np.float32)
    # As in the source, the float32 conversion comes first, so a uint8
    # panorama keeps its 0-255 values.
    if pano.dtype == np.uint8:
        pano = pano.astype(np.float32) / 255.0
    # Downsample the source for the O(out · in) convolution.
    sh, sw = 16, 32
    ys = (np.linspace(0, pano.shape[0] - 1, sh)).astype(int)
    xs = (np.linspace(0, pano.shape[1] - 1, sw)).astype(int)
    src = pano[np.ix_(ys, xs)][..., :3]                   # (sh, sw, 3)

    def dirs(h, w):
        v = (np.arange(h) + 0.5) / h
        u = (np.arange(w) + 0.5) / w
        theta = v * np.pi                     # 0 at +y
        phi = (u - 0.5) * 2 * np.pi           # u=0.5 faces -z
        st = np.sin(theta)[:, None]
        d = np.stack([np.broadcast_to(np.sin(phi)[None, :] * st, (h, w)),
                      np.broadcast_to(np.cos(theta)[:, None], (h, w)),
                      np.broadcast_to(-np.cos(phi)[None, :] * st, (h, w))],
                     axis=-1)
        return d, st

    sd, s_sin = dirs(sh, sw)                  # source dirs + solid angle
    od, _ = dirs(out_h, out_h * 2)
    cos = np.einsum("hwc,ijc->hwij", od, sd)  # (oh, ow, sh, sw)
    w = np.maximum(cos, 0.0) * s_sin[None, None]
    w = w / np.maximum(w.sum(axis=(2, 3), keepdims=True), 1e-9)
    out = np.einsum("hwij,ijc->hwc", w, src).astype(np.float32)
    return np.concatenate(
        [out, np.ones(out.shape[:2] + (1,), np.float32)], axis=-1)
