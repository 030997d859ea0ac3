"""Plain reference texturing: RGBA8 mip chains, the renderer's per-slot
mip selection and the trilinear fetch.

Written from the renderer's stated semantics, with nothing of the program
imported:

  * a texture's chain: level 0 its RGBA8 texels; level k + 1 the 2 x 2
    box average of level k's values before they were stored (an odd
    trailing row or column doubled), down to one texel or 8 levels; every
    level stored as RGBA8, round(x . 255) half to even;
  * the level: chosen once a clip-fan slot, not a pixel (the renderer's
    semantics, where a GPU takes each pixel's screen derivatives):
    lod = 0.5 . log2(max(|uv cross| . texels . |1 / area|, 1)), with
    |uv cross| the authored triangle's uv parallelogram, texels the base
    level's count and area the slot's signed screen area;
  * trilinear: level floor(lod) (clamped into the chain) and the next one
    (the last level where there is none), mixed by the fraction
    lod - floor(lod) rounded to 1/256 (half to even) and capped at
    255/256, 0 where both are one level;
  * bilinear/repeat inside a level: uv wrapped to [0, 1), texel centres
    at half-integers, both neighbours wrapped, bytes / 255.

Every float is computed in the dtype the caller gives (float32 as the
renderer states; bfloat16 for the control).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

MAX_LEVELS = 8


def _box(a: torch.Tensor) -> torch.Tensor:
    """2 x 2 box average of an (h, w, c) float image, an odd trailing row
    or column doubled."""
    if a.shape[0] % 2:
        a = torch.cat([a, a[-1:]], 0)
    if a.shape[1] % 2:
        a = torch.cat([a, a[:, -1:]], 1)
    return (a[0::2, 0::2] + a[0::2, 1::2] + a[1::2, 0::2]
            + a[1::2, 1::2]) * 0.25


def _stored(a: torch.Tensor) -> torch.Tensor:
    return torch.round(a * 255.0).clamp(0, 255).to(torch.uint8)


def mip_chain(image: np.ndarray, device) -> List[torch.Tensor]:
    """The RGBA8 levels of an (h, w, 4) uint8 texture, on `device`.  The
    averages are taken in float32, the precision the renderer states for
    its textures, whatever dtype shades."""
    base = torch.from_numpy(np.ascontiguousarray(image)).to(device)
    levels = [base]
    a = base.float() / torch.full((), 255.0, device=device)
    while len(levels) < MAX_LEVELS and min(a.shape[0], a.shape[1]) > 1:
        a = _box(a)
        levels.append(_stored(a))
    return levels


class Mips:
    """Every level of every texture in one flat (N, 4) uint8 table; each
    (texture id, level) has its start, height and width, levels past a
    chain's end repeating its last."""

    def __init__(self, chains: List[List[torch.Tensor]], device):
        flat, start, size, count = [], [], [], []
        off = 0
        for chain in chains:
            rows_s, rows_z = [], []
            for lv in range(MAX_LEVELS):
                im = chain[min(lv, len(chain) - 1)]
                if lv < len(chain):
                    flat.append(im.reshape(-1, 4))
                    rows_s.append(off)
                    off += im.shape[0] * im.shape[1]
                else:
                    rows_s.append(rows_s[-1])
                rows_z.append((im.shape[0], im.shape[1]))
            start.append(rows_s)
            size.append(rows_z)
            count.append(len(chain))
        self.texels = torch.cat(flat).to(device)
        self.start = torch.tensor(start, dtype=torch.int64, device=device)
        self.size = torch.tensor(size, dtype=torch.int64, device=device)
        self.count = torch.tensor(count, dtype=torch.int64, device=device)

    def bilinear(self, tex: torch.Tensor, level: torch.Tensor,
                 uv: torch.Tensor) -> torch.Tensor:
        """(P, 4) bilinear/repeat samples of level `level` of texture
        `tex` at uv (P, 2), in uv's dtype."""
        dt = uv.dtype
        h, w = self.size[tex, level, 0], self.size[tex, level, 1]
        base = self.start[tex, level]
        f = uv - torch.trunc(uv)
        st = torch.where(f < 0, f + 1.0, f)
        fx = st[:, 0] * w.to(dt) - 0.5
        fy = st[:, 1] * h.to(dt) - 0.5
        x0, y0 = torch.floor(fx), torch.floor(fy)
        tx, ty = (fx - x0)[:, None], (fy - y0)[:, None]
        x0i = torch.remainder(x0.long(), w)
        y0i = torch.remainder(y0.long(), h)
        x1i, y1i = torch.remainder(x0i + 1, w), torch.remainder(y0i + 1, h)
        one = torch.full((), 255.0, dtype=dt, device=uv.device)

        def texel(y, x):
            return self.texels[base + y * w + x].to(dt) / one
        c00, c10 = texel(y0i, x0i), texel(y0i, x1i)
        c01, c11 = texel(y1i, x0i), texel(y1i, x1i)
        top = c00 + (c10 - c00) * tx
        bot = c01 + (c11 - c01) * tx
        return top + (bot - top) * ty

    def base_texels(self, tex: torch.Tensor) -> torch.Tensor:
        s = self.size[tex, 0]
        return s[..., 0] * s[..., 1]


def slot_lod(uv: torch.Tensor, indices: torch.Tensor, slot: torch.Tensor,
             inv_area: torch.Tensor, texels: torch.Tensor) -> torch.Tensor:
    """(n,) lod of the set-up slots `slot` (2 . triangle + fan) with their
    1 / area: the authored triangle's uv parallelogram times its
    texture's base texels, over the slot's screen area."""
    idx = indices[slot // 2]
    e1 = uv[idx[:, 1]] - uv[idx[:, 0]]
    e2 = uv[idx[:, 2]] - uv[idx[:, 0]]
    cross = (e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]).abs()
    ratio = cross * texels.to(uv.dtype) * inv_area.abs()
    return 0.5 * torch.log2(ratio.clamp(min=1.0))


def trilinear(mips: Mips, tex: torch.Tensor, lod: torch.Tensor,
              uv: torch.Tensor) -> torch.Tensor:
    """(P, 4) trilinear samples of texture `tex` at uv with the slots'
    lod, as the module docstring states."""
    top = mips.count[tex] - 1
    fl = torch.floor(lod)
    m0 = torch.minimum(torch.nan_to_num(fl, nan=0.0).clamp(min=0.0).long(),
                       top)
    m1 = torch.minimum(m0 + 1, top)
    frac = torch.where(m1 > m0, lod - fl, torch.zeros_like(lod))
    a = torch.round(frac * 256.0).clamp(0, 255) / 256.0
    t0 = mips.bilinear(tex, m0, uv)
    t1 = mips.bilinear(tex, m1, uv)
    return t0 + (t1 - t0) * a[:, None]
