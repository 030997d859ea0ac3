"""Plain reference shading: the game's fragment shader (a nearest texel of
the triangle's texture, times the vertex colour, half-Lambert lit, fogged
on clip z), the frame's composition over the clear colour and its RGB8
bytes.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench.reference.raster import _dot

def to_bytes(image: np.ndarray) -> np.ndarray:
    """A float image as the RGBA8 texels the shader reads."""
    return np.clip(np.round(np.asarray(image, np.float32) * 255.0),
                   0, 255).astype(np.uint8)


class Textures:
    """Texture id -> its RGBA8 texels on a device (id 0: one white
    texel)."""

    def __init__(self, images: List[np.ndarray], device):
        white = np.ones((1, 1, 4), np.float32)
        self.images = [torch.from_numpy(to_bytes(im)).to(device)
                       for im in [white] + list(images)]

    def fetch(self, tex: int, y, x, dt):
        im = self.images[tex]
        return im[y.long(), x.long()].to(dt) \
            / torch.full((), 255.0, dtype=dt, device=im.device)

    def size(self, tex: int):
        im = self.images[tex]
        return im.shape[0], im.shape[1]


def _wrap(u):
    f = u - torch.trunc(u)
    return torch.where(f < 0, f + 1.0, f)


def nearest(textures: Textures, tex: torch.Tensor, uv: torch.Tensor):
    """Nearest/repeat texel of each fragment's texture."""
    out = torch.ones(uv.shape[0], 4, dtype=uv.dtype, device=uv.device)
    st = _wrap(uv)
    for t in torch.unique(tex).tolist():
        sel = tex == t
        h, w = textures.size(t)
        x = torch.remainder((st[sel, 0] * float(w)).to(torch.int32), w)
        y = torch.remainder((st[sel, 1] * float(h)).to(torch.int32), h)
        out[sel] = textures.fetch(t, y, x, uv.dtype)
    return out


def game_shader(frag: Dict, tex_color: torch.Tensor, u: Dict):
    """Texture x vertex colour, lit by max(0.25, n . -light) as
    0.1 + 0.9 . diffuse, then fogged by the smoothstep of clip z between
    fog_end and fog_start; alpha the unfogged base's."""
    dt = tex_color.dtype

    def c(k):
        return torch.as_tensor(np.asarray(u[k], np.float32)).to(
            device=tex_color.device, dtype=dt)
    diffuse = _dot(frag["world_normal"], -c("light_direction")).clamp(min=0.25)
    base = frag["color"] * tex_color
    lit = base * (0.1 + 0.9 * diffuse[:, None]) * c("light_color")
    z = frag["clip"][:, 2]
    f = ((c("fog_end") - z) / (c("fog_end") - c("fog_start"))).clamp(0, 1)
    fog = f * f * (3.0 - 2.0 * f)
    fc = c("fog_color")
    rgb = fc + (lit - fc) * fog[:, None]
    return torch.cat([rgb[:, :3], base[:, 3:4]], -1)


def compose(frag: Dict, rgba: torch.Tensor, clear, height: int, width: int):
    """The (H, W, 4) frame: each covered pixel's colour blended over the
    clear colour by its alpha where the alpha is above 0."""
    dt = rgba.dtype
    cc = torch.as_tensor(np.asarray(clear, np.float32)).to(
        device=rgba.device, dtype=dt)
    out = cc.expand(height * width, 4).clone()
    a = rgba[:, 3:4]
    mix = rgba * a + cc * (1.0 - a)
    keep = rgba[:, 3] > 0
    out[frag["pixel"][keep]] = mix[keep]
    return out.reshape(height, width, 4)


def rgb8(color: torch.Tensor) -> torch.Tensor:
    """RGBA float to RGB bytes: clipped to [0, 1], times 255, truncated."""
    return (color[..., :3].float().clamp(0.0, 1.0) * 255.0).to(torch.uint8)
