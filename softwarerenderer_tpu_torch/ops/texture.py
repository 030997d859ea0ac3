"""Nearest/repeat atlas sampling (Texture.cs:42-63).

Counterpart of ``_wrap_uv``, ``unpack_rgba8``, ``sample_nearest`` and
``sample_atlas_region`` in ``softwarerenderer_tpu/ops/texture.py``: u = frac(u) (+1 if negative),
x = int(u·w) mod w, inside a per-pixel atlas region (oy, ox, h, w)
resolved per triangle.  Integer wrap is ``torch.remainder`` (floor mod,
like ``jnp`` and Python ``%``), never ``fmod``.

The host (numpy) helpers that build textures and the packed atlas,
``quantize_u8_grid``, ``pack_rgba8``, ``make_texture`` and
``checkerboard``, are copied from the JAX module's numpy path and sit at
the end.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def wrap_uv(uv: torch.Tensor) -> torch.Tensor:
    """u - trunc(u), +1 if negative (Texture.cs:45-48)."""
    frac = uv - torch.trunc(uv)
    return torch.where(frac < 0, frac + 1.0, frac)


def unpack_rgba8(q: torch.Tensor) -> torch.Tensor:
    """uint8 RGBA -> float32 bytes/255, exactly like the reference's Sample.

    The divisor is a tensor on q's device: CUDA divides by a host scalar as
    a multiply by its reciprocal, which is not bytes/255 in every bit."""
    return q.to(torch.float32) / torch.full((), 255.0, device=q.device)


def sample_nearest(texture: Dict, uv: torch.Tensor) -> torch.Tensor:
    """Nearest/repeat sample of one texture's data (h, w, C) at uv
    (..., 2): x = int(u·w) mod w, y likewise; the texels as stored."""
    data = texture["data"]
    h, w = data.shape[0], data.shape[1]
    st = wrap_uv(uv)
    x = torch.remainder((st[..., 0] * float(w)).to(torch.int32), w)
    y = torch.remainder((st[..., 1] * float(h)).to(torch.int32), h)
    return data.reshape(h * w, data.shape[-1])[(y * w + x).long()]


def sample_atlas_region(atlas: torch.Tensor, oy, ox, h, w,
                        uv: torch.Tensor) -> torch.Tensor:
    """Nearest/repeat sample of each pixel's texture region in the RGBA8
    atlas (AH, AW, 4).  oy/ox/h/w are int32 per pixel, uv (..., 2).

    Pixels with no triangle carry h = w = 0; their fetch is clamped into
    the atlas and the caller discards it."""
    ah, aw = atlas.shape[0], atlas.shape[1]
    h = h.clamp(min=1)
    w = w.clamp(min=1)
    st = wrap_uv(uv)
    x = torch.remainder((st[..., 0] * w.to(torch.float32)).to(torch.int32), w)
    y = torch.remainder((st[..., 1] * h.to(torch.float32)).to(torch.int32), h)
    idx = ((oy + y) * aw + (ox + x)).long().clamp(0, ah * aw - 1)
    return unpack_rgba8(atlas.reshape(ah * aw, atlas.shape[-1])[idx])


# ---------------------------------------------------------------------------
# Host helpers (numpy), copied from softwarerenderer_tpu/ops/texture.py
# ---------------------------------------------------------------------------

def quantize_u8_grid(data: np.ndarray) -> np.ndarray:
    """Snap float colors to the u8/255 grid (still float32), the
    reference's byte-image value space (Texture.cs)."""
    q = np.clip(np.round(np.asarray(data, np.float32) * np.float32(255.0)),
                0.0, 255.0).astype(np.float32)
    return q / np.float32(255.0)


def pack_rgba8(data: np.ndarray) -> np.ndarray:
    """(H, W, 4) float32 in [0,1] -> (H, W, 4) uint8 RGBA, the atlas
    format."""
    return np.clip(np.round(np.asarray(data, np.float32) * 255.0),
                   0, 255).astype(np.uint8)


def make_texture(data) -> Dict[str, np.ndarray]:
    """Wrap an (H, W, 4) float32/uint8 array as a texture dict, colors
    snapped to the u8/255 grid."""
    data = np.asarray(data)
    if data.dtype == np.uint8:
        data = data.astype(np.float32) / np.float32(255.0)
    data = np.asarray(data, dtype=np.float32)
    if data.ndim == 2:
        data = data[..., None]
    if data.shape[-1] == 3:
        data = np.concatenate(
            [data, np.ones(data.shape[:-1] + (1,), dtype=np.float32)],
            axis=-1)
    return {"data": quantize_u8_grid(data)}


def checkerboard(size=64, cells=8, color_a=(1.0, 1.0, 1.0, 1.0),
                 color_b=(0.2, 0.2, 0.2, 1.0)) -> Dict[str, np.ndarray]:
    """Procedural checkerboard texture (test/demo asset)."""
    yy, xx = np.mgrid[0:size, 0:size]
    cell = size // cells
    mask = ((xx // cell) + (yy // cell)) % 2 == 0
    data = np.where(mask[..., None],
                    np.asarray(color_a, dtype=np.float32),
                    np.asarray(color_b, dtype=np.float32))
    return make_texture(data.astype(np.float32))
