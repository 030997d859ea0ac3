"""Tile raster: visibility fold + winner resolve + interpolation, then shading.

Counterpart of ``softwarerenderer_tpu/ops/pallas_tile.py`` on the opaque
route (``render_tile_pallas`` with ``shade_rate == 1``).  Its kernel,
``pallas_tile._kernel`` with ``peel=False``, becomes the hand-written CUDA
kernel ``csrc/tile_raster.cu``; ``tile_fold`` launches it for CUDA tensors
and runs ``tile_fold_plain``, its plain PyTorch twin, for CPU tensors.

``prepare`` packs what the fold needs, as ``pallas_tile._prepare_ctx``
does: the per-triangle setup rows (three screen vertices, three depths,
1/area), the binning lists, the per-triangle payload (the varyings the
fragment shader reads, screen positions, 1/area and the per-triangle
extras, for each of the three vertices) and the interpolation plan that
maps payload columns to G-buffer channels.  Triangle ids are int32
throughout; payload rows are indexed by triangle id, so the winner's row is
read once per pixel after the fold.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, Optional

import torch
from torch.profiler import record_function

from softwarerenderer_tpu.config import DepthTest, RenderParams
from softwarerenderer_tpu_torch.ops.binning import bin_triangles, cdiv
from softwarerenderer_tpu_torch.ops.geometry import unflatten_varyings
from softwarerenderer_tpu_torch.ops.raster import blend

F32 = torch.float32
I32 = torch.int32
N_SETUP = 10          # s0x s0y s1x s1y s2x s2y d0 d1 d2 ia
KINDS = {"pc": 0, "pw": 1, "pw3": 2, "bary": 3, "v0": 4}
MAX_TILE_PX = 4096    # the kernel's 256 threads × 16 pixels

# Kernel launches so far; chip_smoke.py resets it and reads it back to show
# that a frame went through the kernel.
LAUNCHES = 0


def prepare(tris: Dict, params: RenderParams, fb_depth: torch.Tensor,
            per_tri_extra: Optional[Dict], gb_keep=None) -> Dict:
    """Bin, pack the setup rows and payload, and build the plan.

    gb_keep: the flat varyings the fragment shader reads, or None for all.
    When "clip_position" is not among them only its (z, w) columns are
    packed and only z reaches the G-buffer (fog reads z, w divides); the
    barycentric channels are written only when "barycentric" is read."""
    tile_w = params.tile_w
    tile_h = min(params.tile_h, 32)
    H, W = params.height, params.width
    nty, ntx = cdiv(H, tile_h), cdiv(W, tile_w)
    Hp, Wp = nty * tile_h, ntx * tile_w
    bins = bin_triangles(tris, params, tile_h, tile_w, params.span_cap)

    screen, valid = tris["screen"], tris["valid"]
    n = screen.shape[0]
    inv_area = torch.where(valid, tris["inv_area"], 0.0)
    setup = torch.cat([screen.reshape(n, 6), tris["depth"],
                       inv_area[:, None]], dim=1).contiguous()

    prune_clip = gb_keep is not None and "clip_position" not in gb_keep
    keys = sorted(tris["attrs"].keys())
    parts, slices, off = [], {}, 0
    for k in keys:
        arr = tris["attrs"][k]
        if k == "clip_position" and prune_clip:
            arr = arr[..., 2:4]
        parts.append(arr)
        slices[k] = (off, off + arr.shape[-1])
        off += arr.shape[-1]
    parts.append(screen)
    sl_screen = off
    off += 2
    parts.append(tris["inv_area"][:, None, None].expand(n, 3, 1))
    sl_ia = off
    off += 1
    extra_keys = sorted(per_tri_extra) if per_tri_extra else []
    extra_slices = {}
    for k in extra_keys:
        v = per_tri_extra[k].to(F32)[:, None, None]
        parts.append(v.expand(n, 3, 1))
        extra_slices[k] = off
        off += 1
    kp = off
    payload = torch.cat(parts, dim=-1).reshape(n, 3 * kp)
    payload = torch.where(valid[:, None], payload, 0.0).contiguous()
    clip_w_off = slices["clip_position"][1] - 1

    plan, gb_slices, j = [], {}, 0
    for k in keys:
        lo, hi = slices[k]
        if k == "clip_position" and prune_clip:
            plan.append(("pc", lo, lo + 1))     # z sits at lo of (z, w)
            gb_slices["clip_z"] = (j, j + 1)
            j += 1
            continue
        if k.startswith("data."):
            plan.append(("pw3" if hi - lo == 3 else "pw", lo, hi))
        else:
            plan.append(("pc", lo, hi))
        gb_slices[k] = (j, j + hi - lo)
        j += hi - lo
    if gb_keep is None or "barycentric" in gb_keep:
        plan.append(("bary", 0, 0))
        gb_slices["barycentric"] = (j, j + 3)
        j += 3
    for k in extra_keys:
        plan.append(("v0", extra_slices[k], 0))
        gb_slices["tri." + k] = (j, j + 1)
        j += 1

    fbd = torch.nn.functional.pad(fb_depth, (0, Wp - W, 0, Hp - H))
    return dict(
        tile_h=tile_h, tile_w=tile_w, H=H, W=W, Hp=Hp, Wp=Wp, kp=kp, kpi=j,
        sl_screen=sl_screen, sl_ia=sl_ia, clip_w_off=clip_w_off,
        plan=tuple(plan),
        gb_slices=gb_slices, extra_keys=extra_keys, fbd=fbd.contiguous(),
        setup=setup, payload=payload, order=bins["order"],
        n_global=bins["n_global"], sorted_tri=bins["sorted_tri"],
        starts=bins["starts"], counts=bins["counts"])


def _plan_channels(plan: tuple, kp: int) -> int:
    """G-buffer channels a plan writes; raises on a payload column outside
    [0, kp) or an unknown kind."""
    n = 0
    for kind, lo, hi in plan:
        if kind not in KINDS:
            raise ValueError(f"unknown plan kind {kind!r}")
        width = {"pw3": 3, "bary": 3, "v0": 1}.get(kind, hi - lo)
        last = {"bary": 0, "v0": lo + 1}.get(kind, lo + width)
        if width < 0 or lo < 0 or last > kp:
            raise ValueError(f"plan entry {(kind, lo, hi)} outside the "
                             f"{kp}-column payload")
        n += width
    return n


@functools.lru_cache(maxsize=None)
def _plan_tensor(plan: tuple, device: torch.device) -> torch.Tensor:
    """The plan as an (n, 3) int32 (kind, lo, hi) tensor on `device`; a
    frame's plan depends only on the shader, so it is uploaded once."""
    return torch.tensor([(KINDS[kd], lo, hi) for kd, lo, hi in plan],
                        dtype=I32).to(device)


def fold_inputs(ctx: Dict):
    """(args, kwargs) of tile_fold / tile_fold_plain for a prepared ctx."""
    args = tuple(ctx[k] for k in ("fbd", "setup", "order", "n_global",
                                  "sorted_tri", "starts", "counts",
                                  "payload", "plan"))
    kwargs = {k: ctx[k] for k in ("tile_h", "tile_w", "kp", "kpi",
                                  "sl_screen", "sl_ia", "clip_w_off")}
    return args, kwargs


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous {dtype} {tuple(shape)} "
                         f"on {device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def _library():
    from softwarerenderer_tpu_torch.kernels import build
    lib = build.load("tile_raster")
    fn = lib.tile_raster_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] \
            + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def tile_fold(fbd, setup, order, n_global, sorted_tri, starts, counts,
              payload, plan, *, tile_h, tile_w, kp, kpi, sl_screen, sl_ia,
              clip_w_off):
    """Fold + resolve + interpolate every tile.

    plan is a tuple of (kind, lo, hi) with kind one of KINDS, mapping
    payload columns to G-buffer channels as pallas_tile's interp_plan does.
    Returns (gbuf (kpi, Hp, Wp) f32, best_d (Hp, Wp) f32, best_i (Hp, Wp)
    i32).  CUDA tensors launch csrc/tile_raster.cu; CPU tensors run
    tile_fold_plain.  There is no fallback from one to the other."""
    global LAUNCHES
    if _plan_channels(plan, kp) > kpi:
        raise ValueError(f"plan writes more than kpi={kpi} channels")
    if min(sl_screen, sl_ia, clip_w_off) < 0 \
            or max(sl_screen + 1, sl_ia, clip_w_off) >= kp:
        raise ValueError(f"payload slots outside the {kp}-column payload")
    if fbd.device.type == "cpu":
        return tile_fold_plain(
            fbd, setup, order, n_global, sorted_tri, starts, counts,
            payload, plan, tile_h=tile_h, tile_w=tile_w, kp=kp, kpi=kpi,
            sl_screen=sl_screen, sl_ia=sl_ia, clip_w_off=clip_w_off)
    if fbd.device.type != "cuda":
        raise ValueError(f"tile_fold runs on cuda or cpu, not {fbd.device}")
    dev = fbd.device
    Hp, Wp = fbd.shape
    if Hp % tile_h or Wp % tile_w or tile_h * tile_w > MAX_TILE_PX:
        raise ValueError(f"bad tiling {tile_h}x{tile_w} for {Hp}x{Wp}")
    ntx, nty = Wp // tile_w, Hp // tile_h
    n = setup.shape[0]
    _check("fbd", fbd, F32, (Hp, Wp), dev)
    _check("setup", setup, F32, (n, N_SETUP), dev)
    _check("order", order, I32, (n,), dev)
    _check("n_global", n_global, I32, (1,), dev)
    _check("sorted_tri", sorted_tri, I32, sorted_tri.shape, dev)
    _check("starts", starts, I32, (ntx * nty,), dev)
    _check("counts", counts, I32, (ntx * nty,), dev)
    _check("payload", payload, F32, (n, 3 * kp), dev)
    plan_t = _plan_tensor(plan, dev)
    gbuf = torch.empty((kpi, Hp, Wp), dtype=F32, device=dev)
    best_d = torch.empty((Hp, Wp), dtype=F32, device=dev)
    best_i = torch.empty((Hp, Wp), dtype=I32, device=dev)
    fn = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(fbd.data_ptr(), setup.data_ptr(), order.data_ptr(),
             n_global.data_ptr(), sorted_tri.data_ptr(), starts.data_ptr(),
             counts.data_ptr(), payload.data_ptr(), plan_t.data_ptr(),
             len(plan), gbuf.data_ptr(), best_d.data_ptr(),
             best_i.data_ptr(), ntx, nty, tile_h, tile_w, kp, kpi,
             sl_screen, sl_ia, clip_w_off, stream)
    if err != 0:
        raise RuntimeError(f"tile_raster kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return gbuf, best_d, best_i


def _order_key(d: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """int64 keys whose order is the lexicographic (depth, id) order.

    -0.0 becomes +0.0 first (the fold compares them equal); the float bits
    are mapped to an int32 of the same order and shifted above idx + 1."""
    bits = (d + 0.0).view(I32).long()
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return bits * (1 << 32) + (idx + 1)


def tile_fold_plain(fbd, setup, order, n_global, sorted_tri, starts, counts,
                    payload, plan, *, tile_h, tile_w, kp, kpi, sl_screen,
                    sl_ia, clip_w_off):
    """tile_fold in plain PyTorch: same inputs, same outputs, same rounding.

    Every (tile, triangle) pair is expanded over the tile's pixels in
    chunks, each fragment becomes an int64 (depth, id) key and a
    scatter-amax keeps the lexicographic max per pixel; the resolve then
    gathers each pixel's winner row and interpolates."""
    dev = fbd.device
    Hp, Wp = fbd.shape
    nty, ntx = Hp // tile_h, Wp // tile_w
    ntiles, tpx = nty * ntx, tile_h * tile_w
    lane = torch.arange(tpx, device=dev)
    lx, ly = lane % tile_w, lane // tile_w
    tiles = torch.arange(ntiles, device=dev)

    ng = int(n_global[0])
    counts = counts.long()
    seg_tile = tiles.repeat_interleave(counts)
    first = counts.cumsum(0) - counts
    seg_pos = starts.long()[seg_tile] + torch.arange(
        seg_tile.numel(), device=dev) - first[seg_tile]
    pair_tile = torch.cat([tiles.repeat_interleave(ng), seg_tile])
    pair_tri = torch.cat([order[:ng].long().repeat(ntiles),
                          sorted_tri.long()[seg_pos]])

    def to_tiles(img):
        return img.reshape(nty, tile_h, ntx, tile_w).permute(0, 2, 1, 3) \
            .reshape(-1)

    def to_image(t):
        return t.reshape(nty, ntx, tile_h, tile_w).permute(0, 2, 1, 3) \
            .reshape(Hp, Wp)

    fbd_t = to_tiles(fbd)
    keys = _order_key(fbd_t, torch.full_like(fbd_t, -1, dtype=torch.long))
    never = torch.iinfo(torch.long).min
    step = max(1, (1 << 22) // tpx)
    for c0 in range(0, pair_tile.numel(), step):
        tl = pair_tile[c0:c0 + step]
        tri = pair_tri[c0:c0 + step]
        px = ((tl % ntx) * tile_w)[:, None] + lx
        py = ((tl // ntx) * tile_h)[:, None] + ly
        px, py = px.to(F32), py.to(F32)
        s = setup[tri]
        s0x, s0y, s1x, s1y, s2x, s2y, d0, d1, d2, ia = (
            s[:, k:k + 1] for k in range(N_SETUP))
        w0 = (s1y - s2y) * (px - s1x) + (s2x - s1x) * (py - s1y)
        w1 = (s2y - s0y) * (px - s2x) + (s0x - s2x) * (py - s2y)
        w2 = (s0y - s1y) * (px - s0x) + (s1x - s0x) * (py - s0y)
        inside = ((w0 >= 0) & (w1 >= 0) & (w2 >= 0)) | \
                 ((w0 <= 0) & (w1 <= 0) & (w2 <= 0))
        d = d0 * (w0 * ia) + d1 * (w1 * ia) + d2 * (w2 * ia)
        ok = inside & (d > float("-inf"))       # NaN and -inf never win
        key = torch.where(ok, _order_key(d, tri[:, None]), never)
        keys.scatter_reduce_(0, (tl[:, None] * tpx + lane).reshape(-1),
                             key.reshape(-1), reduce="amax")

    best_i_t = (keys & 0xFFFFFFFF) - 1
    hi = keys >> 32
    bits = torch.where(hi < 0, hi ^ 0x7FFFFFFF, hi).to(I32).view(F32)
    best_d = to_image(torch.where(best_i_t >= 0, bits, fbd_t))
    best_i = to_image(best_i_t).to(I32)

    bi = best_i.reshape(-1).long()
    has = bi >= 0
    rows = payload[bi.clamp(min=0)]

    def r(v, f):
        return rows[:, v * kp + f]

    px = torch.arange(Wp, device=dev, dtype=F32).repeat(Hp)
    py = torch.arange(Hp, device=dev, dtype=F32).repeat_interleave(Wp)
    ia = r(0, sl_ia)
    s0x, s0y = r(0, sl_screen), r(0, sl_screen + 1)
    s1x, s1y = r(1, sl_screen), r(1, sl_screen + 1)
    s2x, s2y = r(2, sl_screen), r(2, sl_screen + 1)
    w0 = ((s1y - s2y) * (px - s1x) + (s2x - s1x) * (py - s1y)) * ia
    w1 = ((s2y - s0y) * (px - s2x) + (s0x - s2x) * (py - s2y)) * ia
    w2 = ((s0y - s1y) * (px - s0x) + (s1x - s0x) * (py - s0y)) * ia

    def nonzero(x):
        return torch.where(x == 0, 1.0, x)

    rcp_a = w0 / nonzero(r(0, clip_w_off))
    rcp_b = w1 / nonzero(r(1, clip_w_off))
    rcp_c = w2 / nonzero(r(2, clip_w_off))
    wgt = 1.0 / nonzero(rcp_a + rcp_b + rcp_c)
    wa, wb, wc = rcp_a * wgt, rcp_b * wgt, rcp_c * wgt

    def pw(f):
        return r(0, f) * wa + r(1, f) * wb + r(2, f) * wc

    chans = []
    for kind, lo, hi in plan:
        if kind == "pc":
            chans += [(r(0, f) * rcp_a + r(1, f) * rcp_b + r(2, f) * rcp_c)
                      * wgt for f in range(lo, hi)]
        elif kind == "pw":
            chans += [pw(f) for f in range(lo, hi)]
        elif kind == "pw3":
            v = [pw(lo), pw(lo + 1), pw(lo + 2)]
            lsq = v[0] * v[0] + v[1] * v[1] + v[2] * v[2]
            den = torch.sqrt(torch.where(lsq > 0, lsq, 1.0))
            keep = lsq > 1e-6
            chans += [torch.where(keep, c / den, c) for c in v]
        elif kind == "bary":
            chans += [wa, wb, wc]
        else:
            chans.append(r(0, lo))
    zero = torch.zeros(Hp * Wp, dtype=F32, device=dev)
    chans += [zero] * (kpi - len(chans))
    gbuf = torch.where(has, torch.stack(chans), 0.0).reshape(kpi, Hp, Wp)
    return gbuf, best_d, best_i


def frag_from_planes(ctx: Dict, planes: torch.Tensor) -> Dict:
    """The fragment shader's input dict from (kpi, H, W) G-buffer planes."""
    gb_slices = ctx["gb_slices"]
    flat = {k: planes[lo:hi].permute(1, 2, 0)
            for k, (lo, hi) in gb_slices.items() if not k.startswith("tri.")}
    if "clip_z" in flat:
        # Only z was stored; x, y and w are zeros nothing reads.
        z = flat.pop("clip_z")[..., 0]
        zero = torch.zeros_like(z)
        flat["clip_position"] = torch.stack([zero, zero, z, zero], dim=-1)
    frag = unflatten_varyings(
        {k: v for k, v in flat.items() if k != "barycentric"})
    if "barycentric" in flat:
        frag["barycentric"] = flat["barycentric"]
    if ctx["extra_keys"]:
        frag["tri"] = {k: planes[gb_slices["tri." + k][0]].to(I32)
                       for k in ctx["extra_keys"]}
    return frag


def render_tile(tris: Dict, fragment_shader: Callable, uniforms: Dict,
                params: RenderParams, fb_color: torch.Tensor,
                fb_depth: torch.Tensor, per_tri_extra: Optional[Dict] = None,
                fold: Optional[Callable] = None):
    """Full frame: the tile fold, one full-frame shading pass, blend.

    fold: tile_fold (the default) or tile_fold_plain, which lets a check
    on the card render the same frame through the plain twin.
    Returns (color (H, W, 4), depth (H, W))."""
    if params.depth_test != DepthTest.LESS_EQUAL:
        raise NotImplementedError("the tile kernel supports LESS_EQUAL only")
    gb_keep = getattr(fragment_shader, "varyings", None)
    with record_function("tile.bin_pack"):
        ctx = prepare(tris, params, fb_depth, per_tri_extra,
                      None if gb_keep is None else frozenset(gb_keep))
    args, kwargs = fold_inputs(ctx)
    with record_function("tile.fold"):
        gbuf, best_d, best_i = (fold or tile_fold)(*args, **kwargs)
    H, W = ctx["H"], ctx["W"]
    with record_function("tile.shade"):
        color = fragment_shader(frag_from_planes(ctx, gbuf[:, :H, :W]),
                                uniforms)
        written = (best_i[:H, :W] >= 0) & (color[..., 3] > 0)
        out_c = torch.where(written[..., None],
                            blend(color, fb_color, params.blend_mode),
                            fb_color)
        out_d = torch.where(written, best_d[:H, :W], fb_depth)
    return out_c, out_d
