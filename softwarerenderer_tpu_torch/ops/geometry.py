"""Geometry: vertex shading -> assembly -> near clip -> triangle setup.

Counterpart of the eager path of ``softwarerenderer_tpu/ops/geometry.py``
(``build_triangles`` with ``defer_attrs=False``).  Each stage is one batched
tensor op over all vertices or triangles with static shapes:

  * ``shade_vertices``     — the vertex shader over (V, ...) tensors
  * ``assemble_triangles`` — gather vertex outputs into (T, 3, K)
  * ``clip_triangles``     — Sutherland–Hodgman near clip; every input
    triangle yields 2 fan slots with validity masks
  * ``setup_triangles``    — vertex reversal, viewport, depth, signed area,
    cull/degeneracy masks, screen bbox

The JAX module selects clip-table rows with where-chains because TPU
gathers are slow; here they are plain gathers, which pick the same values.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict

import numpy as np
import torch

from softwarerenderer_tpu.config import EPSILON, CullMode

# Sutherland–Hodgman emission table (the JAX module's _CLIP_TABLE): for each
# 3-bit inside mask an ordered polygon of up to 4 sources.  Sources 0-2 are
# the input vertices, 3-5 the intersections on edges 0→1, 1→2, 2→0, and 6 a
# zero pad.
_CLIP_TABLE = np.array([[6, 6, 6, 6], [0, 3, 5, 6], [3, 1, 4, 6],
                        [0, 1, 4, 5], [4, 2, 5, 6], [0, 3, 4, 2],
                        [3, 1, 2, 5], [0, 1, 2, 6]], dtype=np.int64)
_CLIP_COUNT = np.array([0, 3, 3, 4, 3, 4, 4, 3], dtype=np.int64)


@functools.lru_cache(maxsize=None)
def _clip_tables(device: torch.device):
    """Per case: the sources of fan slots (p0, p1, p2) and (p0, p2, p3),
    (8, 6), and the polygon's vertex count, (8,) — on `device`, uploaded
    once."""
    rows = _CLIP_TABLE[:, [0, 1, 2, 0, 2, 3]]
    return (torch.from_numpy(rows).to(device),
            torch.from_numpy(_CLIP_COUNT).to(device))


def shade_vertices(vertex_shader: Callable, vertex_input: Dict,
                   uniforms: Dict) -> Dict:
    """Run the vertex shader over all packed vertices at once."""
    out = vertex_shader(vertex_input, uniforms)
    out.setdefault("data", {})
    return out


def flatten_varyings(vs_out: Dict) -> Dict[str, torch.Tensor]:
    """{k: t, "data": {name: t}} -> flat dict with "data."-prefixed keys."""
    flat = {k: v for k, v in vs_out.items() if k != "data"}
    for name, arr in vs_out.get("data", {}).items():
        flat["data." + name] = arr
    return flat


def unflatten_varyings(flat: Dict[str, torch.Tensor]) -> Dict:
    out = {k: v for k, v in flat.items() if not k.startswith("data.")}
    out["data"] = {k[len("data."):]: v for k, v in flat.items()
                   if k.startswith("data.")}
    return out


def assemble_triangles(vs_out: Dict, indices: torch.Tensor
                       ) -> Dict[str, torch.Tensor]:
    """Gather per-vertex outputs into per-triangle (T, 3, K) tensors."""
    idx = indices.reshape(-1, 3).long()
    return {k: v[idx] for k, v in flatten_varyings(vs_out).items()}


def clip_triangles(attrs: Dict[str, torch.Tensor], near_clip: torch.Tensor):
    """Near-plane clip of (T, 3, K) attrs -> ((2T, 3, K) attrs, (2T,) valid).

    Fan slots [2t] = (p0, p1, p2) and [2t+1] = (p0, p2, p3) in the
    reference's emission order; an unclipped triangle passes through slot
    [2t].  Clipping fires only when some but not all clip w <= 0; the clip
    plane is z >= near·w with the reference's t formula, its |denom| < ε →
    0.5 fallback and [0, 1] clamp (Rasterizer.cs:95-224).  The varyings
    (float32) are clipped together as one (T, 3, ΣK) tensor."""
    clip = attrs["clip_position"]
    near = near_clip
    z = clip[..., 2]
    w = clip[..., 3]
    w_nonpos = w <= 0
    any_out = w_nonpos.any(-1)
    all_out = w_nonpos.all(-1)
    inside = (z >= near * w).long()
    bits = inside[:, 0] + 2 * inside[:, 1] + 4 * inside[:, 2]
    case = torch.where(all_out, 0, torch.where(any_out, bits, 7))

    # edge i runs vertex i -> vertex (i + 1) % 3
    z1, w1 = z.roll(-1, 1), w.roll(-1, 1)
    denom = (z1 - z) - near * (w1 - w)
    t_raw = (z - near * w) / torch.where(denom == 0, 1.0,
                                         near * (w1 - w) - (z1 - z))
    t = torch.where(denom.abs() < EPSILON, 0.5, t_raw.clamp(0.0, 1.0))

    fan_rows, counts = _clip_tables(clip.device)
    rows, count = fan_rows[case], counts[case]          # (T, 6), (T,)

    keys = list(attrs)
    widths = [attrs[k].shape[-1] for k in keys]
    a = torch.cat([attrs[k] for k in keys], dim=-1)      # (T, 3, ΣK)
    x = a + (a.roll(-1, 1) - a) * t[..., None]           # Shaders.Lerp order
    cand = torch.cat([a, x, torch.zeros_like(a[:, :1])], dim=1)
    picked = torch.gather(cand, 1, rows[..., None].expand(-1, -1, a.shape[-1]))
    out = picked.reshape(-1, 3, a.shape[-1]).split(widths, dim=-1)
    valid = torch.stack([count >= 3, count == 4], dim=1).reshape(-1)
    return dict(zip(keys, out)), valid


def _edge_function(ax, ay, bx, by, cx, cy):
    """(c-a) × (b-a) — Rasterizer.cs:561-563."""
    return (cx - ax) * (by - ay) - (cy - ay) * (bx - ax)


def setup_triangles(attrs: Dict[str, torch.Tensor], valid: torch.Tensor,
                    width: int, height: int, cull_mode: CullMode) -> Dict:
    """DrawTriangle setup (Rasterizer.cs:342-399), batched.

    Reverses vertex order to {v2, v1, v0}; screen positions with a Y flip
    and pixel centres at integer coordinates; per-vertex depth (ndcZ+1)/2;
    the "screen_coords" varying; signed area; validity masks; and the
    clamped screen bbox [min_x, min_y, max_x, max_y] as int32."""
    attrs = {k: v.flip(1) for k, v in attrs.items()}
    clip = attrs["clip_position"]
    w = clip[..., 3]
    inv_w = 1.0 / w
    ndc = clip[..., :3] * inv_w[..., None]

    fw = float(np.float32(width))
    fh = float(np.float32(height))
    sx = (ndc[..., 0] * 0.5 + 0.5) * fw
    sy = (1.0 - (ndc[..., 1] * 0.5 + 0.5)) * fh
    screen = torch.stack([sx, sy], dim=-1)
    depth = (ndc[..., 2] + 1.0) * 0.5

    inv_w1 = float(np.float32(1.0) / np.float32(width - 1))
    inv_h1 = float(np.float32(1.0) / np.float32(height - 1))
    attrs["screen_coords"] = torch.stack([sx * inv_w1, sy * inv_h1], dim=-1)

    area = _edge_function(sx[:, 0], sy[:, 0], sx[:, 1], sy[:, 1],
                          sx[:, 2], sy[:, 2])
    finite = torch.isfinite(ndc).all(-1).all(-1)
    w_nonzero = (w != 0).all(-1)
    is_front = area < 0
    if cull_mode == CullMode.BACK:
        cull_ok = is_front
    elif cull_mode == CullMode.FRONT:
        cull_ok = ~is_front
    else:
        cull_ok = torch.ones_like(is_front)
    valid = valid & finite & w_nonzero & (area != 0) & cull_ok

    # Clamped to [-1, size] before the int cast: a float beyond int32 range
    # has no defined cast in torch, and any value outside the screen leaves
    # the min <= max test below with the same answer.
    def to_i32(v, size):
        return v.clamp(-1, size).to(torch.int32)

    min_x = to_i32(torch.floor(sx.amin(1)).clamp(min=0), width)
    max_x = to_i32(torch.ceil(sx.amax(1)).clamp(max=width - 1), width)
    min_y = to_i32(torch.floor(sy.amin(1)).clamp(min=0), height)
    max_y = to_i32(torch.ceil(sy.amax(1)).clamp(max=height - 1), height)
    valid = valid & (min_x <= max_x) & (min_y <= max_y)

    safe_area = torch.where(area == 0, 1.0, area)
    return {
        "screen": screen,
        "depth": depth,
        "area": area,
        "inv_area": 1.0 / safe_area,
        "valid": valid,
        "bbox": torch.stack([min_x, min_y, max_x, max_y], dim=-1),
        "attrs": attrs,
    }


def build_triangles(vertex_shader: Callable, vertex_input: Dict,
                    indices: torch.Tensor, uniforms: Dict, *,
                    width: int, height: int,
                    cull_mode: CullMode = CullMode.BACK,
                    tri_mask: torch.Tensor | None = None,
                    keep_varyings=None) -> Dict:
    """Full geometry stage: shade -> assemble -> clip -> setup.

    uniforms["near_clip"] (a 0-d float32 tensor) places the clip plane.
    tri_mask: optional (T,) bool per input triangle (the frustum-cull mask).
    keep_varyings: the flat varying names the fragment shader reads; the
    rest are dropped before clipping (clip_position is always kept)."""
    vs_out = shade_vertices(vertex_shader, vertex_input, uniforms)
    attrs = assemble_triangles(vs_out, indices)
    if keep_varyings is not None:
        keep = set(keep_varyings) | {"clip_position"}
        attrs = {k: v for k, v in attrs.items() if k in keep}
    attrs2, valid = clip_triangles(attrs, uniforms["near_clip"])
    if tri_mask is not None:
        valid = valid & tri_mask.repeat_interleave(2)
    tris = setup_triangles(attrs2, valid, width, height, cull_mode)
    if keep_varyings is not None and "screen_coords" not in keep_varyings:
        tris["attrs"].pop("screen_coords", None)
    return tris
