"""Plain reference rasterizer: a packed scene and a camera to per-pixel
winners and their interpolated fragments.

Written from the renderer's stated semantics, with nothing of the program
imported and nothing it made taken in:

  * the camera: a right-handed look-at from a position and a quaternion,
    and the row-vector perspective whose clip w is the view depth (depth
    0 at the near plane, 1 at the far one);
  * the frustum test of each mesh's bounding sphere and the LOD level of
    each mesh (how many of its pixel thresholds lie above the projected
    radius of its bounding sphere);
  * the vertex stage (world = p . M, clip = world . V . P, the world
    normal normalised) and the near clip (z >= near . w), whose every
    input triangle yields two fan slots;
  * set-up: vertices reversed, screen x right and y down with pixel
    centres at whole coordinates, depth (ndc z + 1) / 2, back faces (a
    signed area >= 0) and empty boxes dropped;
  * visibility: each pixel keeps the covering fragment of largest depth
    and, among equal depths, the later slot (the renderer's LESS_EQUAL),
    over every (slot, pixel) pair of each slot's screen box;
  * the winner's fragment: perspective-correct weights, the world normal
    renormalised.

Every float is computed in ``dt`` (float32 as the renderer states;
bfloat16 for the control); pair blocks keep the memory bounded at 4K.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

# (slot, pixel) pairs evaluated at once.
PAIR_BLOCK = 1 << 22
CLIP_EPS = 1e-6

# Sutherland-Hodgman polygons of the near clip, by the 3-bit mask of the
# vertices inside: sources 0-2 the vertices, 3-5 the crossings of edges
# 0-1, 1-2, 2-0, 6 nothing.
_POLY = [[6, 6, 6, 6], [0, 3, 5, 6], [3, 1, 4, 6], [0, 1, 4, 5],
         [4, 2, 5, 6], [0, 3, 4, 2], [3, 1, 2, 5], [0, 1, 2, 6]]
_NVERT = [0, 3, 3, 4, 3, 4, 4, 3]


def bounding_sphere(positions: np.ndarray):
    """Ritter's three passes over float32 points: the farthest point p1
    from the first, the farthest p2 from p1, then the (p1, p2) sphere
    grown over each point outside it, in index order."""
    p = np.asarray(positions, np.float32)
    d0 = np.sum((p - p[0]) ** 2, axis=-1)
    p1 = p[np.argmax(d0)]
    d1 = np.sum((p - p1) ** 2, axis=-1)
    i2 = int(np.argmax(d1))
    center = (p1 + p[i2]) * np.float32(0.5)
    radius = np.float32(np.sqrt(d1[i2]) * 0.5)
    for q in p:
        dist = float(np.linalg.norm(q - center))
        if dist > radius:
            grown = (radius + dist) * 0.5
            center = center + (q - center) * ((grown - radius) / dist)
            radius = np.float32(grown)
    return center.astype(np.float32), float(radius)


def pack(draws: List[Dict], device, dt) -> Dict[str, torch.Tensor]:
    """The scene as flat tensors: each draw {"mesh", "matrix",
    "texture_id"} appends its vertices and its triangles, every LOD level
    after the authored one, in draw order."""
    pos, nrm, col, uv, vmesh = [], [], [], [], []
    idx, tmesh, tlevel, ttex = [], [], [], []
    mats, centers, radii, lod_px = [], [], [], []
    spheres = {}
    v_off = 0
    for m, d in enumerate(draws):
        mesh = d["mesh"]
        v = mesh["position"].shape[0]
        pos.append(mesh["position"])
        nrm.append(mesh["normal"])
        col.append(mesh["color"])
        uv.append(mesh["uv"])
        vmesh.append(np.full(v, m, np.int64))
        levels = [mesh["indices"]] + list(mesh.get("lod_indices", []))
        for li, lv in enumerate(levels):
            lv = np.asarray(lv, np.int64).reshape(-1, 3)
            idx.append(lv + v_off)
            tmesh.append(np.full(len(lv), m, np.int64))
            tlevel.append(np.full(len(lv), li, np.int64))
            ttex.append(np.full(len(lv), d.get("texture_id", 0), np.int64))
        if id(mesh) not in spheres:
            spheres[id(mesh)] = bounding_sphere(mesh["position"])
        c, r = spheres[id(mesh)]
        centers.append(c)
        radii.append(r)
        mats.append(np.asarray(d["matrix"], np.float32))
        lod_px.append(list(mesh.get("lod_px", [])))
        v_off += v
    n_lod = max(1, max(len(x) for x in lod_px))
    px = np.full((len(draws), n_lod), -np.inf, np.float32)
    for m, x in enumerate(lod_px):
        px[m, :len(x)] = x

    def f(a):
        return torch.from_numpy(np.ascontiguousarray(
            np.concatenate(a) if isinstance(a, list) else a,
            dtype=np.float32)).to(device=device, dtype=dt)

    def i(a):
        return torch.from_numpy(np.concatenate(a)).to(device)
    return {"position": f(pos), "normal": f(nrm), "color": f(col),
            "uv": f(uv), "vert_mesh": i(vmesh), "indices": i(idx),
            "tri_mesh": i(tmesh), "tri_level": i(tlevel),
            "tri_tex": i(ttex), "matrix": f(np.stack(mats)),
            "center": f(np.stack(centers)),
            "radius": f(np.asarray(radii, np.float32)), "lod_px": f(px)}


def _dot(a, b):
    p = a * b
    out = p[..., 0]
    for k in range(1, p.shape[-1]):
        out = out + p[..., k]
    return out


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _rows(v, m):
    """v . M for row vectors v (..., k) and matrices (..., k', 4) whose
    first k rows are used, summed in row order."""
    out = v[..., 0:1] * m[..., 0, :]
    for k in range(1, v.shape[-1]):
        out = out + v[..., k:k + 1] * m[..., k, :]
    return out


def camera(cam: Dict, width: int, height: int, dt) -> Dict:
    """View and projection (4, 4) of a camera {"position", "rotation"
    (x, y, z, w), "fov_degrees", "near_clip", "far_clip"}, on the host."""
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32)).to(dt)  # noqa
    pos, q = t(cam["position"]), t(cam["rotation"])

    def rotate(v):
        v = t(v)
        tt = 2.0 * _cross(q[:3], v)
        return v + q[3] * tt + _cross(q[:3], tt)
    front, up = rotate([0.0, 0.0, -1.0]), rotate([0.0, 1.0, 0.0])

    def unit(v):
        return v / torch.sqrt(_dot(v, v))
    z = unit(pos - (pos + front))
    x = unit(_cross(up, z))
    y = _cross(z, x)
    view = torch.zeros(4, 4, dtype=dt)
    view[:3, 0], view[:3, 1], view[:3, 2] = x, y, z
    view[3, 0], view[3, 1], view[3, 2] = -_dot(x, pos), -_dot(y, pos), \
        -_dot(z, pos)
    view[3, 3] = 1.0
    fov = t(cam["fov_degrees"]) * float(np.float32(np.pi / 180.0))
    tan_half = torch.tan(fov * 0.5)
    ys = 1.0 / tan_half
    xs = ys / float(np.float32(width) / np.float32(height))
    near, far = t(cam["near_clip"]), t(cam["far_clip"])
    proj = torch.zeros(4, 4, dtype=dt)
    proj[0, 0], proj[1, 1] = xs, ys
    proj[2, 2] = far / (near - far)
    proj[2, 3] = -1.0
    proj[3, 2] = near * (far / (near - far))
    return {"view": view, "proj": proj, "tan_half": tan_half,
            "position": pos, "near": near}


def _world_spheres(sc: Dict):
    """Each mesh's bounding sphere in the world: the centre through its
    matrix, the radius times the largest row norm of its 3 x 3."""
    mm = sc["matrix"]
    wc = _rows(sc["center"], mm[:, :3, :3]) + mm[:, 3, :3]
    return wc, sc["radius"] * torch.sqrt(_dot(mm[:, :3, :3],
                                              mm[:, :3, :3])).amax(-1)


def lod_mask(sc: Dict, cm: Dict, height: int) -> torch.Tensor:
    """(T,) the triangles of each mesh's LOD level for a frame `height`
    pixels high: the level is the number of the mesh's thresholds above
    the projected radius of its sphere (the distance at least near)."""
    dev = sc["position"].device
    wc, wr = _world_spheres(sc)
    off = wc - cm["position"].to(dev)
    d = torch.maximum(torch.sqrt(_dot(off, off).clamp(min=1e-12)),
                      cm["near"].to(dev))
    px_r = wr / d * float(np.float32(height * 0.5)) / cm["tan_half"].to(dev)
    level = (px_r[:, None] < sc["lod_px"]).sum(1)
    return level[sc["tri_mesh"]] == sc["tri_level"]


def drawn_triangles(sc: Dict, cm: Dict, height: int) -> torch.Tensor:
    """Ids of the triangles drawn, in order: the mesh's bounding sphere
    inside all six frustum planes, and the triangle of its LOD level."""
    dev = sc["position"].device
    wc, wr = _world_spheres(sc)
    vp = (cm["view"] @ cm["proj"]).to(dev)
    raw = torch.stack([vp[:, 3] + vp[:, 2], vp[:, 3] - vp[:, 2],
                       vp[:, 3] + vp[:, 0], vp[:, 3] - vp[:, 0],
                       vp[:, 3] + vp[:, 1], vp[:, 3] - vp[:, 1]])
    planes = raw / torch.sqrt(_dot(raw[:, :3], raw[:, :3]))[:, None]
    dist = _dot(wc[:, None, :], planes[None, :, :3]) + planes[:, 3]
    visible = (dist > -wr[:, None]).all(-1)
    keep = visible[sc["tri_mesh"]] & lod_mask(sc, cm, height)
    return torch.nonzero(keep).squeeze(1)


def geometry(sc: Dict, cm: Dict, tri_ids: torch.Tensor, width: int,
             height: int, varyings: Dict) -> Dict:
    """The drawn triangles' fan slots after the vertex stage, the near
    clip and set-up.  varyings: name -> (V, k) per-vertex values carried
    to the fragments (clip z rides along for the fog).  Returns the
    valid slots' ids (2 . triangle + fan), screen corners (n, 3, 2),
    depths (n, 3), clip w (n, 3), 1/area (n,), boxes (n, 4) and varyings
    (n, 3, k)."""
    dev, dt = sc["position"].device, sc["position"].dtype
    view, proj = cm["view"].to(dev), cm["proj"].to(dev)
    m = sc["matrix"][sc["vert_mesh"]]
    one = torch.ones_like(sc["position"][:, :1])
    world = _rows(torch.cat([sc["position"], one], -1), m)
    clip = _rows(_rows(world, view), proj)
    names = list(varyings)
    vals = torch.cat([clip] + [varyings[k] for k in names], -1)
    widths = [4] + [varyings[k].shape[-1] for k in names]
    corner = vals[sc["indices"][tri_ids]]                     # (T, 3, K)

    # Near clip: only when some but not all clip w are <= 0.
    z, w = corner[..., 2], corner[..., 3]
    out = w <= 0
    inside = (z >= cm["near"].to(dev) * w).long()
    mask = inside[:, 0] + 2 * inside[:, 1] + 4 * inside[:, 2]
    case = torch.where(out.all(-1), 0, torch.where(out.any(-1), mask, 7))
    near = cm["near"].to(dev)
    z1, w1 = z.roll(-1, 1), w.roll(-1, 1)
    den = (z1 - z) - near * (w1 - w)
    tcut = (z - near * w) / torch.where(den == 0, 1.0,
                                        near * (w1 - w) - (z1 - z))
    tcut = torch.where(den.abs() < CLIP_EPS, 0.5, tcut.clamp(0.0, 1.0))
    cut = corner + (corner.roll(-1, 1) - corner) * tcut[..., None]
    src = torch.cat([corner, cut, torch.zeros_like(corner[:, :1])], 1)
    poly = torch.tensor(_POLY, device=dev)[case]              # (T, 4)
    nvert = torch.tensor(_NVERT, device=dev)[case]
    fan = poly[:, [0, 1, 2, 0, 2, 3]].reshape(-1, 2, 3)
    slots = torch.gather(src[:, None].expand(-1, 2, -1, -1), 2,
                         fan[..., None].expand(-1, -1, -1, src.shape[-1]))
    slots = slots.reshape(-1, 3, src.shape[-1])
    fan_ok = torch.stack([nvert >= 3, nvert == 4], 1).reshape(-1)
    slot_id = (2 * tri_ids[:, None] + torch.arange(2, device=dev)).reshape(-1)

    # Set-up, vertices reversed.
    slots = slots.flip(1)
    cw = slots[..., 3]
    ndc = slots[..., :3] * (1.0 / cw)[..., None]
    sx = (ndc[..., 0] * 0.5 + 0.5) * float(width)
    sy = (1.0 - (ndc[..., 1] * 0.5 + 0.5)) * float(height)
    depth = (ndc[..., 2] + 1.0) * 0.5
    area = (sx[:, 2] - sx[:, 0]) * (sy[:, 1] - sy[:, 0]) \
        - (sy[:, 2] - sy[:, 0]) * (sx[:, 1] - sx[:, 0])
    ok = fan_ok & torch.isfinite(ndc).all(-1).all(-1) & (cw != 0).all(-1) \
        & (area < 0)
    lo_x = torch.floor(sx.amin(1)).clamp(0, width)
    hi_x = torch.ceil(sx.amax(1)).clamp(-1, width - 1)
    lo_y = torch.floor(sy.amin(1)).clamp(0, height)
    hi_y = torch.ceil(sy.amax(1)).clamp(-1, height - 1)
    box = torch.stack([lo_x, lo_y, hi_x, hi_y], -1).float() \
        .nan_to_num(0.0).long()
    ok = ok & (box[:, 0] <= box[:, 2]) & (box[:, 1] <= box[:, 3])
    keep = torch.nonzero(ok).squeeze(1)
    parts = slots[keep].split(widths, -1)
    return {"slot": slot_id[keep], "screen": torch.stack([sx, sy], -1)[keep],
            "depth": depth[keep], "clip_w": cw[keep],
            "inv_area": 1.0 / area[keep], "box": box[keep],
            "var": dict(zip(["clip"] + names, parts))}


def _pairs(box: torch.Tensor, first: int, last: int):
    """(slot row, px, py) of every pixel in the boxes of rows
    first..last-1."""
    b = box[first:last]
    bw = b[:, 2] - b[:, 0] + 1
    n = bw * (b[:, 3] - b[:, 1] + 1)
    row = torch.repeat_interleave(torch.arange(first, last,
                                               device=box.device), n)
    start = torch.cumsum(n, 0) - n
    k = torch.arange(int(n.sum()), device=box.device) \
        - torch.repeat_interleave(start, n)
    rb = row - first
    return row, b[rb, 0] + k % bw[rb], b[rb, 1] + k // bw[rb]


def _edges(s, px, py):
    """Edge values of corners s (n, 3, 2) at pixel centres (px, py)."""
    s0x, s0y = s[:, 0, 0], s[:, 0, 1]
    s1x, s1y = s[:, 1, 0], s[:, 1, 1]
    s2x, s2y = s[:, 2, 0], s[:, 2, 1]
    return ((s1y - s2y) * (px - s1x) + (s2x - s1x) * (py - s1y),
            (s2y - s0y) * (px - s2x) + (s0x - s2x) * (py - s2y),
            (s0y - s1y) * (px - s0x) + (s1x - s0x) * (py - s0y))


def _ordered(d32: torch.Tensor) -> torch.Tensor:
    """int64 with the order of float32 d32 (-0 as +0)."""
    bits = (d32 + 0.0).view(torch.int32).long()
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def _blocks(box: torch.Tensor):
    """Row ranges whose boxes hold at most PAIR_BLOCK pixels together (a
    larger box alone)."""
    area = ((box[:, 2] - box[:, 0] + 1) * (box[:, 3] - box[:, 1] + 1)).cpu()
    csum = torch.cumsum(area, 0).numpy()
    first, n = 0, len(csum)
    while first < n:
        base = csum[first - 1] if first else 0
        last = int(np.searchsorted(csum, base + PAIR_BLOCK, "right"))
        last = max(last, first + 1)
        yield first, last
        first = last


def visibility(g: Dict, width: int, height: int):
    """Per-pixel winner row into g (-1 where nothing covers) and the
    number of (slot, pixel) pairs whose pixel centre the slot covers."""
    dev, dt = g["screen"].device, g["screen"].dtype
    best = torch.full((height * width,), torch.iinfo(torch.int64).min,
                      dtype=torch.int64, device=dev)
    covered_pairs = 0
    for first, last in _blocks(g["box"]):
        row, px, py = _pairs(g["box"], first, last)
        s = g["screen"][row]
        e = _edges(s, px.to(dt), py.to(dt))
        inside = ((e[0] >= 0) & (e[1] >= 0) & (e[2] >= 0)) | \
            ((e[0] <= 0) & (e[1] <= 0) & (e[2] <= 0))
        ia, dv = g["inv_area"][row], g["depth"][row]
        d = dv[:, 0] * (e[0] * ia) + dv[:, 1] * (e[1] * ia) \
            + dv[:, 2] * (e[2] * ia)
        ok = inside & ~torch.isnan(d)
        covered_pairs += int(ok.sum())
        key = _ordered(d[ok].float()) * (1 << 32) + row[ok] + 1
        best.scatter_reduce_(0, (py * width + px)[ok], key, "amax")
    won = best != torch.iinfo(torch.int64).min
    win = torch.where(won, (best & 0xFFFFFFFF) - 1, -1)
    return win.reshape(height, width), covered_pairs


def fragments(g: Dict, win: torch.Tensor) -> Dict:
    """The interpolated varyings of each covered pixel's winner, (P, k)
    over the covered pixels, with their flat pixel index."""
    height, width = win.shape
    flat = torch.nonzero(win.reshape(-1) >= 0).squeeze(1)
    r = win.reshape(-1)[flat]
    dt = g["screen"].dtype
    px, py = (flat % width).to(dt), (flat // width).to(dt)
    e = _edges(g["screen"][r], px, py)
    ia, cw = g["inv_area"][r], g["clip_w"][r]
    rcp = [e[v] * ia / cw[:, v] for v in range(3)]
    s = rcp[0] + rcp[1] + rcp[2]
    norm = 1.0 / torch.where(s == 0, 1.0, s)
    out = {"pixel": flat, "row": r}
    for k, a in g["var"].items():
        a = a[r]
        if k == "world_normal":
            v = a[:, 0] * (rcp[0] * norm)[:, None] \
                + a[:, 1] * (rcp[1] * norm)[:, None] \
                + a[:, 2] * (rcp[2] * norm)[:, None]
            lsq = _dot(v, v)
            den = torch.sqrt(torch.where(lsq > 0, lsq, 1.0))
            v = torch.where((lsq > 1e-6)[:, None], v / den[:, None], v)
        else:
            v = (a[:, 0] * rcp[0][:, None] + a[:, 1] * rcp[1][:, None]
                 + a[:, 2] * rcp[2][:, None]) * norm[:, None]
        out[k] = v
    return out


def vertex_varyings(sc: Dict) -> Dict[str, torch.Tensor]:
    """The game's varyings a vertex: colour, uv and the world normal
    (n . M's 3 x 3, normalised)."""
    m = sc["matrix"][sc["vert_mesh"]]
    n = _rows(sc["normal"], m[:, :3, :3])
    ln = torch.sqrt(_dot(n, n))
    n = n / torch.where(ln < 1e-30, torch.ones_like(ln), ln)[:, None]
    return {"color": sc["color"], "uv": sc["uv"], "world_normal": n}


def counts(sc: Dict, cam: Dict, width: int,
           height: int) -> Dict[str, int]:
    """What a frame asks of the raster: valid slots, covered pixels and
    covered (slot, pixel) pairs."""
    cm = camera(cam, width, height, sc["position"].dtype)
    tri = drawn_triangles(sc, cm, height)
    g = geometry(sc, cm, tri, width, height, {})
    win, pairs = visibility(g, width, height)
    return {"valid_slots": int(g["slot"].numel()),
            "covered_pixels": int((win >= 0).sum()),
            "covered_pairs": pairs}


def raster(sc: Dict, cam: Dict, width: int, height: int) -> Dict:
    """One frame's visibility and fragments: {"win", "frag", "geom",
    "covered_pairs"}."""
    cm = camera(cam, width, height, sc["position"].dtype)
    tri = drawn_triangles(sc, cm, height)
    g = geometry(sc, cm, tri, width, height, vertex_varyings(sc))
    win, pairs = visibility(g, width, height)
    return {"win": win, "frag": fragments(g, win), "geom": g,
            "covered_pairs": pairs}
