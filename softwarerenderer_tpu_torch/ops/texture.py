"""Atlas sampling: nearest/repeat (Texture.cs:42-63) and bilinear.

Counterpart of ``_wrap_uv``, ``unpack_rgba8``, ``sample_nearest``,
``sample_atlas_region``, ``sample_atlas_nearest`` and the bilinear samplers
(``sample_atlas_region_bilinear``, ``sample_atlas_bilinear``,
``sample_bilinear``) in ``softwarerenderer_tpu/ops/texture.py``: u =
frac(u) (+1 if negative), x = int(u·w) mod w, inside a per-pixel atlas
region (oy, ox, h, w) resolved per triangle or looked up by texture id.
Bilinear filtering puts texel centres at half-integers and wraps both
neighbours.  A NaN coordinate casts to texel 0, as on the card and in
JAX.  Integer wrap is ``torch.remainder`` (floor mod, like ``jnp`` and
Python ``%``), never ``fmod``.  An atlas is RGBA8 rows (the
packed scene's) or float32 rows (a panorama may be either).

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


def texel_index(x: torch.Tensor) -> torch.Tensor:
    """x.to(int32) as the card and XLA cast a NaN: to 0 (the CPU's cast
    gives INT_MIN, which picks another texel of a region whose size is not
    a power of two).  The nearest samplers cast a wrapped coordinate times
    the size, a NaN or a value inside the texture, where the casts
    agree."""
    if x.device.type == "cpu":
        x = torch.nan_to_num(x, nan=0.0)
    return x.to(torch.int32)


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
    x = torch.remainder(texel_index(st[..., 0] * float(w)), w)
    y = torch.remainder(texel_index(st[..., 1] * float(h)), h)
    return data.reshape(h * w, data.shape[-1])[(y * w + x).long()]


def sample_atlas_region(atlas: torch.Tensor, oy, ox, h, w,
                        uv: torch.Tensor) -> torch.Tensor:
    """Nearest/repeat sample of each pixel's texture region in the RGBA8
    atlas (AH, AW, 4).  oy/ox/h/w are int32 per pixel, uv (..., 2).

    Pixels with no triangle carry h = w = 0; their fetch is clamped into
    the atlas and the caller discards it."""
    aw = atlas.shape[1]
    h = h.clamp(min=1)
    w = w.clamp(min=1)
    st = wrap_uv(uv)
    x = torch.remainder(texel_index(st[..., 0] * w.to(torch.float32)), w)
    y = torch.remainder(texel_index(st[..., 1] * h.to(torch.float32)), h)
    return atlas_fetch(atlas, (oy + y) * aw + (ox + x))


def sample_atlas_nearest(atlas: torch.Tensor, offsets: torch.Tensor,
                         sizes: torch.Tensor, tex_id: torch.Tensor,
                         uv: torch.Tensor) -> torch.Tensor:
    """Nearest/repeat sample inside texture `tex_id`'s atlas region, looked
    up in the (N, 2) int32 offsets (y, x) and sizes (h, w) tables: the
    integer semantics of sample_nearest (Texture.cs:42-63) within the
    region.  atlas: (AH, AW, 4) RGBA8 or float32; tex_id (...,) int32; uv
    (..., 2).  The JAX package looks the region up by a one-hot matmul on
    its device, in float32, exact for these integers; here it is an
    index."""
    tid = tex_id.long().clamp(0, offsets.shape[0] - 1)
    off, size = offsets[tid].to(torch.int32), sizes[tid].to(torch.int32)
    return sample_atlas_region(atlas, off[..., 0], off[..., 1],
                               size[..., 0], size[..., 1], uv)


def atlas_fetch(atlas: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """One row gather a texel: `idx` flat texel indices into the (AH, AW,
    C) atlas, clamped into it; u8 rows as bytes/255, other rows as
    float32."""
    ah, aw = atlas.shape[0], atlas.shape[1]
    rows = atlas.reshape(ah * aw, atlas.shape[-1])[
        idx.long().clamp(0, ah * aw - 1)]
    if rows.dtype == torch.uint8:
        return unpack_rgba8(rows)
    return rows.to(torch.float32)


def _bilinear(fetch, h, w, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear filtering with repeat wrap over a (h, w) texture (ints or
    int tensors broadcast with uv's leading shape), texel centres at
    half-integers: fetch(y, x) gives the texels at integer coordinates.
    The cast to int32 follows the floor, as in JAX; the wrap brings any
    cast (NaN's included) back into the texture, where fetch clamps."""
    st = wrap_uv(uv)
    wf = w.to(torch.float32) if isinstance(w, torch.Tensor) else float(w)
    hf = h.to(torch.float32) if isinstance(h, torch.Tensor) else float(h)
    fx = st[..., 0] * wf - 0.5
    fy = st[..., 1] * hf - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    x0i = torch.remainder(x0.to(torch.int32), w)
    y0i = torch.remainder(y0.to(torch.int32), h)
    x1i = torch.remainder(x0i + 1, w)
    y1i = torch.remainder(y0i + 1, h)
    c00 = fetch(y0i, x0i)
    c10 = fetch(y0i, x1i)
    c01 = fetch(y1i, x0i)
    c11 = fetch(y1i, x1i)
    top = c00 + (c10 - c00) * tx
    bot = c01 + (c11 - c01) * tx
    return top + (bot - top) * ty


def sample_atlas_region_bilinear(atlas: torch.Tensor, oy, ox, h, w,
                                 uv: torch.Tensor) -> torch.Tensor:
    """Bilinear/repeat sample inside each pixel's atlas region (oy, ox,
    h, w), int32 per pixel: the trilinear shader's fetch, one region a mip,
    and the panorama's (a region of the whole image).  Pixels with no
    triangle (h = w = 0) fetch a clamped texel the caller discards."""
    aw = atlas.shape[1]
    h = h.clamp(min=1)
    w = w.clamp(min=1)
    return _bilinear(lambda y, x: atlas_fetch(atlas, (oy + y) * aw + (ox + x)),
                     h, w, uv)


def sample_atlas_bilinear(atlas: torch.Tensor, offsets: torch.Tensor,
                          sizes: torch.Tensor, tex_id: torch.Tensor,
                          uv: torch.Tensor) -> torch.Tensor:
    """Bilinear/repeat sample inside texture `tex_id`'s atlas region,
    looked up in the (N, 2) offsets and sizes tables (the bilinear
    shader's fetch).  The JAX package looks the region up by a one-hot
    matmul on its device, in float32, exact for these integers; here it
    is an index."""
    tid = tex_id.long().clamp(0, offsets.shape[0] - 1)
    off, size = offsets[tid].to(torch.int32), sizes[tid].to(torch.int32)
    return sample_atlas_region_bilinear(atlas, off[..., 0], off[..., 1],
                                        size[..., 0], size[..., 1], uv)


def sample_bilinear(texture: Dict, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear/repeat sample of one texture's data (h, w, C) at uv
    (..., 2); the texels as stored."""
    data = texture["data"]
    h, w = data.shape[0], data.shape[1]
    flat = data.reshape(h * w, data.shape[-1])
    return _bilinear(lambda y, x: flat[(y * w + x).long()], h, w, uv)


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
