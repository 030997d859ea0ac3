"""Tile raster: visibility fold + winner resolve + interpolation, then shading.

Counterpart of ``softwarerenderer_tpu/ops/pallas_tile.py``: the opaque
route (``render_tile_pallas``, ``shade_rate`` included), the depth-peeled
K-buffer (``render_tile_pallas_kbuffer``) and its single-pass sibling
(``render_tile_pallas_kbuffer_single``).  Their kernels become hand-written
CUDA kernels: ``pallas_tile._kernel`` (``peel=False`` and ``peel=True``) is
``csrc/tile_raster.cu`` behind ``tile_fold``, and ``_kernel_kdeep`` is
``csrc/tile_kdeep.cu`` behind ``tile_fold_kdeep``.  Each wrapper launches
its kernel for CUDA tensors and runs its plain PyTorch twin
(``tile_fold_plain``, ``tile_fold_kdeep_plain``) for CPU tensors.

``prepare`` packs what the fold needs, as ``pallas_tile._prepare_ctx``
does: the per-triangle setup rows (three screen vertices, three depths,
1/area), the binning lists, the per-triangle payload (the varyings the
fragment shader reads, screen positions, 1/area and the per-triangle
extras, for each of the three vertices) and the interpolation plan that
maps payload columns to G-buffer channels.  Triangle ids are int32
throughout; payload rows are indexed by triangle id, so the winner's row is
read once per pixel after the fold.

The opaque route's shading pass (``render_tile``) has a kernel of its own
for the scene shaders, ``csrc/tile_shade.cu`` behind ``ops/tile_shade.py``,
whose plain twin is ``shade_plain``.

A band of a sharded frame (``parallel.sharding``) folds tiles that are not
its own screen rows: ``prepare(origin=, bins=)`` takes the band's bins and
its tile origin map (``binning.tile_pixels``), which ``tile_fold`` hands
the kernel and its twin; without one the fold is the frame's, as it
always was.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, Optional

import torch
from softwarerenderer_tpu_torch.utils.profiling import span

from softwarerenderer_tpu_torch.config import BlendMode, DepthTest, RenderParams
from softwarerenderer_tpu_torch.ops.binning import (bin_triangles, cdiv,
                                                   pixel_coords, tile_pairs,
                                                   tile_pixels, to_image,
                                                   to_tiles)
from softwarerenderer_tpu_torch.ops.geometry import unflatten_varyings
from softwarerenderer_tpu_torch.ops import forward, raster, tile_shade
from softwarerenderer_tpu_torch.ops.raster import (DEPTH_CLEAR, blend,
                                                  setup_rows)

F32 = torch.float32
I32 = torch.int32
N_SETUP = 10          # s0x s0y s1x s1y s2x s2y d0 d1 d2 ia
KINDS = {"pc": 0, "pw": 1, "pw3": 2, "bary": 3, "v0": 4}
BLOCK_PX = 1024       # pixels a block of tile_raster.cu owns: any tile_h x
                      # tile_w runs as cdiv(tile_h * tile_w, BLOCK_PX) blocks
MAX_KDEEP = 8         # the deepest K tile_kdeep.cu is instantiated for
GLOB_RESIDENT = 256   # the fewest globals params.global_cap keeps: the
                      # TPU kernel's resident global block, a semantic of
                      # the cap (pallas_tile.GLOB_RESIDENT)

# Kernel launches so far, one count per kernel: K1 (tile_fold, opaque
# mode), K2 (tile_fold with prev maps, peel mode), each without a tile
# origin map and with one (MAPPED_*: a band of a sharded frame), and K3
# (tile_fold_kdeep).  chip_smoke.py resets them and reads them back to show
# that a frame went through the kernels.
LAUNCHES = 0
PEEL_LAUNCHES = 0
MAPPED_LAUNCHES = 0
MAPPED_PEEL_LAUNCHES = 0
KDEEP_LAUNCHES = 0


def prepare(tris: Dict, params: RenderParams, fb_depth: torch.Tensor,
            per_tri_extra: Optional[Dict], gb_keep=None,
            origin: Optional[torch.Tensor] = None,
            bins: Optional[Dict] = None) -> Dict:
    """Bin, pack the setup rows and payload (pack_payload), and build the
    plan.

    gb_keep: the flat varyings the fragment shader reads, or None for all
    (pack_payload).  params.height x params.width is the stored frame: the
    screen, or a band of a sharded frame whose tiles sit at the screen
    origins of `origin` ((ntiles, 2) int32, binning.tile_pixels) with its
    `bins` at this tiling (binning.bin_triangles at the band's row offset,
    or binning.bin_tiles for a band of any tiles)."""
    tile_w = params.tile_w
    tile_h = min(params.tile_h, 32)
    H, W = params.height, params.width
    nty, ntx = cdiv(H, tile_h), cdiv(W, tile_w)
    Hp, Wp = nty * tile_h, ntx * tile_w
    if bins is None:
        bins = bin_triangles(tris, params, tile_h, tile_w, params.span_cap)
    n = tris["screen"].shape[0]

    # params.global_cap: the fold streams only the first max(global_cap,
    # GLOB_RESIDENT) entries of `order`, whose globals lead it in
    # submission order, so n_global is clamped to that length on the
    # device (no host read); past it the last-submitted globals drop.
    n_global = bins["n_global"]
    gcap = int(params.global_cap or 0)
    if gcap and gcap < n:
        n_global = n_global.clamp(max=max(gcap, GLOB_RESIDENT))
    fbd = torch.nn.functional.pad(fb_depth, (0, Wp - W, 0, Hp - H))
    return dict(
        pack_payload(tris, per_tri_extra, gb_keep),
        tile_h=tile_h, tile_w=tile_w, H=H, W=W, Hp=Hp, Wp=Wp,
        fbd=fbd.contiguous(), setup=setup_rows(tris), order=bins["order"],
        n_global=n_global, sorted_tri=bins["sorted_tri"],
        starts=bins["starts"], counts=bins["counts"], origin=origin)


def pack_payload(tris: Dict, per_tri_extra: Optional[Dict],
                 gb_keep=None) -> Dict:
    """The per-triangle payload rows the resolve reads and the plan that
    maps them to G-buffer channels: {"payload" (N, 3*kp) f32, zero rows
    for invalid slots, "plan", "kp", "kpi", "sl_screen", "sl_ia",
    "clip_w_off", "gb_slices", "extra_keys"}.

    gb_keep: the flat varyings the fragment shader reads, or None for all.
    When "clip_position" is not among them only its (z, w) columns are
    packed and only z reaches the G-buffer (fog reads z, w divides); the
    barycentric channels are written only when "barycentric" is read."""
    screen, valid = tris["screen"], tris["valid"]
    n = screen.shape[0]
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
    return dict(kp=kp, kpi=j, sl_screen=sl_screen, sl_ia=sl_ia,
                clip_w_off=clip_w_off, plan=tuple(plan), gb_slices=gb_slices,
                extra_keys=extra_keys, payload=payload)


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
    """(args, kwargs) of tile_fold / tile_fold_plain for a prepared ctx
    (with its tile origin map when it has one); tile_fold_kdeep takes the
    same plus K, for a ctx without a map."""
    args = tuple(ctx[k] for k in ("fbd", "setup", "order", "n_global",
                                  "sorted_tri", "starts", "counts",
                                  "payload", "plan"))
    kwargs = {k: ctx[k] for k in ("tile_h", "tile_w", "kp", "kpi",
                                  "sl_screen", "sl_ia", "clip_w_off")}
    if ctx["origin"] is not None:
        kwargs["origin"] = ctx["origin"]
    return args, kwargs


def check_tensor(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous {dtype} {tuple(shape)} "
                         f"on {device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def _check_layout(plan, kp, kpi, sl_screen, sl_ia, clip_w_off):
    """Raise on a plan or payload slot the kernels would read out of
    bounds (both devices)."""
    if _plan_channels(plan, kp) > kpi:
        raise ValueError(f"plan writes more than kpi={kpi} channels")
    if min(sl_screen, sl_ia, clip_w_off) < 0 \
            or max(sl_screen + 1, sl_ia, clip_w_off) >= kp:
        raise ValueError(f"payload slots outside the {kp}-column payload")


def _check_inputs(fbd, setup, order, n_global, sorted_tri, starts, counts,
                  payload, tile_h, tile_w, kp):
    """What a tile kernel takes: dtype, shape, contiguity and one device
    (fbd's) for every input, a tiling that divides the frame and a set-up
    table on an 8-byte boundary (the kernels read it as float2); returns
    (ntx, nty)."""
    dev = fbd.device
    Hp, Wp = fbd.shape
    if tile_h <= 0 or tile_w <= 0 or Hp % tile_h or Wp % tile_w:
        raise ValueError(f"bad tiling {tile_h}x{tile_w} for {Hp}x{Wp}")
    ntx, nty = Wp // tile_w, Hp // tile_h
    n = setup.shape[0]
    check_tensor("fbd", fbd, F32, (Hp, Wp), dev)
    check_tensor("setup", setup, F32, (n, N_SETUP), dev)
    check_tensor("order", order, I32, (n,), dev)
    check_tensor("n_global", n_global, I32, (1,), dev)
    check_tensor("sorted_tri", sorted_tri, I32, sorted_tri.shape, dev)
    check_tensor("starts", starts, I32, (ntx * nty,), dev)
    check_tensor("counts", counts, I32, (ntx * nty,), dev)
    check_tensor("payload", payload, F32, (n, 3 * kp), dev)
    if setup.data_ptr() % 8:
        raise ValueError("setup must start on an 8-byte boundary")
    return ntx, nty


def tile_order(counts: torch.Tensor) -> torch.Tensor:
    """The order in which tile_raster.cu's blocks take the tiles: longest
    binned list first, equal counts in tile order (a stable sort), so the
    busiest tiles start in the first wave of blocks and short ones fill
    the tail.  counts (ntiles,) int32; returns a permutation of
    range(ntiles) as int64 on counts' device, with no host read.  The
    fold does not depend on it: any permutation gives the same outputs."""
    return torch.argsort(counts, descending=True, stable=True)


def dead_pixels(prev_d: torch.Tensor, prev_i: torch.Tensor) -> torch.Tensor:
    """The pixels at which a peel pass can admit no fragment, whatever the
    triangles: no previous winner (prev_i < 0) and a previous depth that is
    not above DEPTH_CLEAR (DEPTH_CLEAR itself, -inf or NaN).  A fragment is
    admitted if it ranks strictly below (prev_d, prev_i); there "d <
    prev_d" needs d = -inf, which never wins, and "d == prev_d and id <
    prev_i" needs id < -1.  Every other pixel is live.  tile_raster.cu
    folds live pixels only; tile_fold_plain gives a dead pixel (fbd, -1)
    and a zero G-buffer.  On a K-buffer frame's own maps (prev_i = -1
    paired with DEPTH_CLEAR) live means prev_i >= 0."""
    return (prev_i < 0) & ~(prev_d > DEPTH_CLEAR)


def _entry(lib_name: str, fn_name: str, n_ptr_head: int, n_int_tail: int):
    """The C entry point fn_name of csrc/<lib_name>.cu with its argtypes:
    n_ptr_head pointers, n_plan, the three output pointers, n_int_tail
    ints, the stream."""
    from softwarerenderer_tpu_torch.kernels import build
    fn = getattr(build.load(lib_name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptr_head + [ctypes.c_int] \
            + [ctypes.c_void_p] * 3 + [ctypes.c_int] * n_int_tail \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def tile_fold(fbd, setup, order, n_global, sorted_tri, starts, counts,
              payload, plan, *, tile_h, tile_w, kp, kpi, sl_screen, sl_ia,
              clip_w_off, prev_d=None, prev_i=None, origin=None):
    """Fold + resolve + interpolate every tile.

    plan is a tuple of (kind, lo, hi) with kind one of KINDS, mapping
    payload columns to G-buffer channels as pallas_tile's interp_plan does.
    With prev_d (Hp, Wp) f32 and prev_i (Hp, Wp) int32, the previous
    pass's winners, the fold peels: a fragment is admitted only if it ranks
    strictly below its pixel's (prev_d, prev_i) in the (depth, id) order
    and is not that winner, and a tile with no prev_i >= 0 folds nothing.
    With origin, an (ntiles, 2) int32 tensor of each tile's screen (y0,
    x0) (binning.tile_pixels), a pixel is folded and resolved at its
    tile's screen origin plus its place in the tile and stored where it
    is; without one a tile sits at its own place on the screen.
    Returns (gbuf (kpi, Hp, Wp) f32, best_d (Hp, Wp) f32, best_i (Hp, Wp)
    i32).  CUDA tensors launch csrc/tile_raster.cu; CPU tensors run
    tile_fold_plain.  There is no fallback from one to the other.

    The kernel takes any tile_h x tile_w that divides the frame: a block
    owns BLOCK_PX pixels of a tile, blocks take the tiles in tile_order
    (longest list first), and a peel pass folds only the pixels that are
    not dead_pixels.  None of that shows in the outputs."""
    global LAUNCHES, PEEL_LAUNCHES, MAPPED_LAUNCHES, MAPPED_PEEL_LAUNCHES
    _check_layout(plan, kp, kpi, sl_screen, sl_ia, clip_w_off)
    peel = prev_d is not None
    if peel != (prev_i is not None):
        raise ValueError("prev_d and prev_i are given together or not at all")
    if fbd.device.type == "cpu":
        return tile_fold_plain(
            fbd, setup, order, n_global, sorted_tri, starts, counts,
            payload, plan, tile_h=tile_h, tile_w=tile_w, kp=kp, kpi=kpi,
            sl_screen=sl_screen, sl_ia=sl_ia, clip_w_off=clip_w_off,
            prev_d=prev_d, prev_i=prev_i, origin=origin)
    if fbd.device.type != "cuda":
        raise ValueError(f"tile_fold runs on cuda or cpu, not {fbd.device}")
    ntx, nty = _check_inputs(fbd, setup, order, n_global, sorted_tri, starts,
                             counts, payload, tile_h, tile_w, kp)
    dev = fbd.device
    Hp, Wp = fbd.shape
    if origin is not None:
        check_tensor("origin", origin, I32, (ntx * nty, 2), dev)
    prev_ptrs = (None, None)
    if peel:
        check_tensor("prev_d", prev_d, F32, (Hp, Wp), dev)
        check_tensor("prev_i", prev_i, I32, (Hp, Wp), dev)
        prev_ptrs = (prev_d.data_ptr(), prev_i.data_ptr())
    plan_t = _plan_tensor(plan, dev)
    tiles = tile_order(counts)
    gbuf = torch.empty((kpi, Hp, Wp), dtype=F32, device=dev)
    best_d = torch.empty((Hp, Wp), dtype=F32, device=dev)
    best_i = torch.empty((Hp, Wp), dtype=I32, device=dev)
    fn = _entry("tile_raster", "tile_raster_launch", 13, 9)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(fbd.data_ptr(), *prev_ptrs, setup.data_ptr(), order.data_ptr(),
             n_global.data_ptr(), sorted_tri.data_ptr(), starts.data_ptr(),
             counts.data_ptr(), tiles.data_ptr(),
             None if origin is None else origin.data_ptr(),
             payload.data_ptr(), plan_t.data_ptr(),
             len(plan), gbuf.data_ptr(), best_d.data_ptr(),
             best_i.data_ptr(), ntx, nty, tile_h, tile_w, kp, kpi,
             sl_screen, sl_ia, clip_w_off, stream)
    if err != 0:
        raise RuntimeError(f"tile_raster kernel launch failed: CUDA error "
                           f"{err}")
    if peel and origin is not None:
        MAPPED_PEEL_LAUNCHES += 1
    elif peel:
        PEEL_LAUNCHES += 1
    elif origin is not None:
        MAPPED_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return gbuf, best_d, best_i


def tile_fold_kdeep(fbd, setup, order, n_global, sorted_tri, starts, counts,
                    payload, plan, *, K, tile_h, tile_w, kp, kpi, sl_screen,
                    sl_ia, clip_w_off):
    """The K best fragments of every pixel in one fold, each resolved and
    interpolated.

    Same inputs as tile_fold's opaque mode.  Slot s of a pixel holds its
    s-th best (depth, id) among the fragments with depth >= fbd, later ids
    winning ties: the winner of s peel passes without a stop.  Returns
    (gbuf (K*kpi, Hp, Wp) f32, layer s in planes [s*kpi, (s+1)*kpi),
    best_d (K, Hp, Wp) f32 with -inf in empty slots, best_i (K, Hp, Wp)
    i32 with -1 in empty slots).  1 <= K <= MAX_KDEEP.  CUDA tensors
    launch csrc/tile_kdeep.cu; CPU tensors run tile_fold_kdeep_plain.

    The kernel takes any tile_h x tile_w that divides the frame, in blocks
    of BLOCK_PX pixels that take the tiles in tile_order, as tile_fold's
    does; none of that shows in the outputs."""
    global KDEEP_LAUNCHES
    if not 1 <= K <= MAX_KDEEP:
        raise ValueError(f"tile_fold_kdeep takes 1 <= K <= {MAX_KDEEP}, "
                         f"got K={K}")
    _check_layout(plan, kp, kpi, sl_screen, sl_ia, clip_w_off)
    if fbd.device.type == "cpu":
        return tile_fold_kdeep_plain(
            fbd, setup, order, n_global, sorted_tri, starts, counts,
            payload, plan, K=K, tile_h=tile_h, tile_w=tile_w, kp=kp,
            kpi=kpi, sl_screen=sl_screen, sl_ia=sl_ia,
            clip_w_off=clip_w_off)
    if fbd.device.type != "cuda":
        raise ValueError(f"tile_fold_kdeep runs on cuda or cpu, not "
                         f"{fbd.device}")
    outputs, call, _keep = kdeep_launch_args(
        fbd, setup, order, n_global, sorted_tri, starts, counts, payload,
        plan, K=K, tile_h=tile_h, tile_w=tile_w, kp=kp, kpi=kpi,
        sl_screen=sl_screen, sl_ia=sl_ia, clip_w_off=clip_w_off)
    fn = _entry("tile_kdeep", "tile_kdeep_launch", 10, 10)
    err = fn(*call, torch.cuda.current_stream(fbd.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tile_kdeep kernel launch failed: CUDA error "
                           f"{err}")
    KDEEP_LAUNCHES += 1
    return outputs


def kdeep_launch_args(fbd, setup, order, n_global, sorted_tri, starts,
                      counts, payload, plan, *, K, tile_h, tile_w, kp, kpi,
                      sl_screen, sl_ia, clip_w_off):
    """What tile_fold_kdeep hands csrc/tile_kdeep.cu, on fbd's device:
    checks the inputs (_check_inputs), computes the tile order and
    allocates the outputs.  Returns ((gbuf, best_d, best_i), the entry
    point's arguments up to the stream, the tensors made here that the
    launch reads: (tile order, plan))."""
    ntx, nty = _check_inputs(fbd, setup, order, n_global, sorted_tri, starts,
                             counts, payload, tile_h, tile_w, kp)
    dev = fbd.device
    Hp, Wp = fbd.shape
    plan_t = _plan_tensor(plan, dev)
    tiles = tile_order(counts)
    gbuf = torch.empty((K * kpi, Hp, Wp), dtype=F32, device=dev)
    best_d = torch.empty((K, Hp, Wp), dtype=F32, device=dev)
    best_i = torch.empty((K, Hp, Wp), dtype=I32, device=dev)
    call = (fbd.data_ptr(), setup.data_ptr(), order.data_ptr(),
            n_global.data_ptr(), sorted_tri.data_ptr(), starts.data_ptr(),
            counts.data_ptr(), tiles.data_ptr(), payload.data_ptr(),
            plan_t.data_ptr(), len(plan), gbuf.data_ptr(),
            best_d.data_ptr(), best_i.data_ptr(), ntx, nty, tile_h, tile_w,
            kp, kpi, sl_screen, sl_ia, clip_w_off, K)
    return (gbuf, best_d, best_i), call, (tiles, plan_t)


def tile_fold_plain(fbd, setup, order, n_global, sorted_tri, starts, counts,
                    payload, plan, *, tile_h, tile_w, kp, kpi, sl_screen,
                    sl_ia, clip_w_off, prev_d=None, prev_i=None, origin=None):
    """tile_fold in plain PyTorch: same inputs, same outputs, same rounding.

    Every (tile, triangle) pair is expanded over the tile's pixels in
    chunks, each fragment becomes an int64 (depth, id) key
    (raster.fold_keys) and a scatter-amax keeps the lexicographic max per
    pixel; the resolve then
    gathers each pixel's winner row and interpolates.  With prev maps a
    fragment is admitted only if its key is below its pixel's
    (prev_d, prev_i) key and its id is not prev_i, and the pairs of tiles
    with no prev_i >= 0 are dropped, as the kernel skips those tiles.  With
    origin a pixel sits at its tile's screen origin (binning.tile_pixels),
    for the fold and the resolve alike."""
    dev = fbd.device
    Hp, Wp = fbd.shape
    nty, ntx = Hp // tile_h, Wp // tile_w
    ntiles, tpx = nty * ntx, tile_h * tile_w
    lane = torch.arange(tpx, device=dev)
    pair_tile, pair_tri = tile_pairs(order, n_global, sorted_tri, starts,
                                     counts)

    def tiled(img):
        return to_tiles(img, tile_h, tile_w)

    def to_image_(t):
        return to_image(t, Hp, Wp, tile_h, tile_w)

    le = DepthTest.LESS_EQUAL
    peel = prev_d is not None
    if peel:
        prev_i_t = tiled(prev_i).long()
        prev_d_t = tiled(prev_d)
        prev_key = raster.fold_keys(prev_d_t, prev_i_t, le)
        # Nothing ranks below a NaN depth (the kernel's float compares all
        # fail), whatever its bits would make of it as a key.
        prev_key = torch.where(torch.isnan(prev_d_t), raster.NEVER, prev_key)
        live = (prev_i_t.reshape(ntiles, tpx) >= 0).any(1)
        keep = live[pair_tile]
        pair_tile, pair_tri = pair_tile[keep], pair_tri[keep]

    fbd_t = tiled(fbd)
    keys = raster.fold_keys(fbd_t, torch.full_like(
        fbd_t, raster.NO_TRI, dtype=torch.long), le)
    step = max(1, raster.MAX_CHUNK_ELEMS // tpx)
    for c0 in range(0, pair_tile.numel(), step):
        tl = pair_tile[c0:c0 + step]
        tri = pair_tri[c0:c0 + step]
        px, py = tile_pixels(tl, ntx, tile_h, tile_w, origin)
        inside, d = raster.fragments(setup[tri], px, py)
        ok = inside & (d > float("-inf"))       # NaN and -inf never win
        key = raster.fold_keys(d, tri[:, None], le)
        pix = (tl[:, None] * tpx + lane).reshape(-1)
        if peel:
            # "strictly below (pd, pi)" is key < key(pd, pi), with -0.0
            # and +0.0 one depth as in the kernel's float compares.
            ok &= (tri[:, None] != prev_i_t[pix].reshape(ok.shape)) \
                & (key < prev_key[pix].reshape(ok.shape))
        key = torch.where(ok, key, raster.NEVER)
        keys.scatter_reduce_(0, pix, key.reshape(-1), reduce="amax")

    best_d, best_i = raster.decode_keys(keys, fbd_t, le)
    best_d, best_i = to_image_(best_d), to_image_(best_i)
    return _resolve_plain(payload, plan, best_i, kp, kpi, sl_screen, sl_ia,
                          clip_w_off, origin, tile_h, tile_w), best_d, best_i


def _resolve_plain(payload, plan, best_i, kp, kpi, sl_screen, sl_ia,
                   clip_w_off, origin=None, tile_h=1, tile_w=1):
    """The (kpi, Hp, Wp) G-buffer of the winners best_i (Hp, Wp): each
    pixel's payload row gathered and interpolated at its screen position
    (its storage position, or by the tile origin map at tile_h x tile_w
    tiles), zeros where best_i is -1."""
    Hp, Wp = best_i.shape
    bi = best_i.reshape(-1).long()
    px, py = pixel_coords(Hp, Wp, tile_h, tile_w, payload.device, origin) \
        if origin is not None else (None, None)
    return resolve_rows(payload[bi.clamp(min=0)], bi >= 0, plan, kp, kpi,
                        sl_screen, sl_ia, clip_w_off, px, py, Wp) \
        .reshape(kpi, Hp, Wp)


def resolve_rows(rows, has, plan, kp, kpi, sl_screen, sl_ia, clip_w_off,
                 px=None, py=None, width=None):
    """The (kpi, P) G-buffer of P pixels from each one's winner payload
    row, rows (P, 3*kp), interpolated at screen (px, py) (flat f32; by
    default the pixels of a frame `width` wide, row-major), zeros where
    `has` is False: K1's resolve in plain PyTorch."""
    dev = rows.device

    def r(v, f):
        return rows[:, v * kp + f]

    if px is None:
        Hp = rows.shape[0] // width
        px = torch.arange(width, device=dev, dtype=F32).repeat(Hp)
        py = torch.arange(Hp, device=dev, dtype=F32).repeat_interleave(width)
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
    zero = torch.zeros(rows.shape[0], dtype=F32, device=dev)
    chans += [zero] * (kpi - len(chans))
    return torch.where(has, torch.stack(chans), 0.0)


def tile_fold_kdeep_plain(fbd, setup, order, n_global, sorted_tri, starts,
                          counts, payload, plan, *, K, tile_h, tile_w, kp,
                          kpi, sl_screen, sl_ia, clip_w_off):
    """tile_fold_kdeep in plain PyTorch: tile_fold_plain, then K - 1 peel
    rounds of it, each taking the previous round's winners unstopped; layer
    s is the best fragment strictly below layer s - 1, which is the K-deep
    fold's slot s.  Empty slots get depth -inf, as the kernel's."""
    kwargs = dict(tile_h=tile_h, tile_w=tile_w, kp=kp, kpi=kpi,
                  sl_screen=sl_screen, sl_ia=sl_ia, clip_w_off=clip_w_off)
    args = (fbd, setup, order, n_global, sorted_tri, starts, counts,
            payload, plan)
    gbufs, depths, ids = [], [], []
    prev = {}
    for _ in range(K):
        gbuf, best_d, best_i = tile_fold_plain(*args, **kwargs, **prev)
        gbufs.append(gbuf)
        depths.append(torch.where(best_i >= 0, best_d, float("-inf")))
        ids.append(best_i)
        prev = dict(prev_d=best_d, prev_i=best_i)
    return torch.cat(gbufs), torch.stack(depths), torch.stack(ids)


def frag_from_planes(ctx: Dict, planes: torch.Tensor) -> Dict:
    """The fragment shader's input dict from (kpi, A, B) G-buffer planes:
    a full (H, W) frame or a block of (segments, pixels)."""
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


def _prepare_for(tris, fragment_shader, params, fb_depth, per_tri_extra,
                 band=None):
    if params.depth_test != DepthTest.LESS_EQUAL:
        raise NotImplementedError("the tile kernels support LESS_EQUAL only")
    gb_keep = getattr(fragment_shader, "varyings", None)
    with span("tile.bin_pack"):
        return prepare(tris, params, fb_depth, per_tri_extra,
                       None if gb_keep is None else frozenset(gb_keep),
                       **(band or {}))


def render_tile(tris: Dict, fragment_shader: Callable, uniforms: Dict,
                params: RenderParams, fb_color: torch.Tensor,
                fb_depth: torch.Tensor, per_tri_extra: Optional[Dict] = None,
                fold: Optional[Callable] = None, band: Optional[Dict] = None):
    """Full frame: the tile fold, one full-frame shading pass, blend.

    With params.shade_rate = sr > 1 the fold stays at full resolution and
    the shader runs on every sr-th row of the G-buffer, each shaded row
    repeated down its block of sr rows (pallas_tile.py:1072-1089); the
    height must divide by sr.

    The shading pass is one launch of csrc/tile_shade.cu where
    tile_shade.fused_fetch finds the shader's fused form (the scene
    shaders on the card), else its plain twin shade_plain.

    fold: tile_fold (the default) or tile_fold_plain, which lets a check
    on the card render the same frame through the plain twin.  band:
    prepare's origin and bins for a band of a sharded frame, whose
    params.height x params.width are the band's.
    Returns (color (H, W, 4), depth (H, W))."""
    sr = int(params.shade_rate)
    if sr > 1 and params.height % sr:
        raise ValueError(f"shade_rate={sr} needs the frame height "
                         f"divisible by it, got {params.height}")
    ctx = _prepare_for(tris, fragment_shader, params, fb_depth,
                       per_tri_extra, band)
    args, kwargs = fold_inputs(ctx)
    with span("tile.fold"):
        gbuf, best_d, best_i = (fold or tile_fold)(*args, **kwargs)
    with span("tile.shade"):
        fetch = tile_shade.fused_fetch(fragment_shader, ctx, gbuf)
        if fetch is not None:
            return tile_shade.shade(fetch, ctx, gbuf, best_d, best_i,
                                    uniforms, params, fb_color, fb_depth)
        return shade_plain(ctx, gbuf, best_d, best_i, fragment_shader,
                           uniforms, params, fb_color, fb_depth)


def shade_plain(ctx: Dict, gbuf: torch.Tensor, best_d: torch.Tensor,
                best_i: torch.Tensor, fragment_shader: Callable,
                uniforms: Dict, params: RenderParams, fb_color: torch.Tensor,
                fb_depth: torch.Tensor):
    """render_tile's shading pass in plain PyTorch, for any shader: the
    shader over the fold's G-buffer planes (every params.shade_rate-th row
    of the ctx["H"] x ctx["W"] frame, repeated down its block), then the
    blend where the pixel has a winner and the shaded alpha is above 0,
    and the winner's depth there.  The twin of tile_shade.shade.
    Returns (color (H, W, 4), depth (H, W))."""
    sr = int(params.shade_rate)
    H, W = ctx["H"], ctx["W"]
    color = fragment_shader(frag_from_planes(ctx, gbuf[:, :H:sr, :W]),
                            uniforms)
    if sr > 1:
        color = color.repeat_interleave(sr, 0)
    written = (best_i[:H, :W] >= 0) & (color[..., 3] > 0)
    out_c = torch.where(written[..., None],
                        blend(color, fb_color, params.blend_mode), fb_color)
    out_d = torch.where(written, best_d[:H, :W], fb_depth)
    return out_c, out_d


def _compaction(params: RenderParams):
    """(seg, seg_cap) of segment-compacted layer shading
    (params.kbuffer_compact_rows, pallas_tile.py:1197-1206), or None when
    the frame is not compactable."""
    H, W = params.height, params.width
    seg = 128
    while seg > 8 and W % seg:
        seg //= 2
    frac = params.kbuffer_compact_rows
    if not (frac > 0 and W % seg == 0):
        return None
    nseg = W // seg
    seg_cap = int(H * nseg * frac)
    seg_cap = min(H * nseg, max(8, -(-seg_cap // 8) * 8))
    return (seg, seg_cap) if seg_cap < H * nseg else None


def render_tile_kbuffer(tris: Dict, fragment_shader: Callable,
                        uniforms: Dict, params: RenderParams,
                        fb_color: torch.Tensor, fb_depth: torch.Tensor,
                        per_tri_extra: Optional[Dict] = None,
                        fold: Optional[Callable] = None,
                        with_stats: bool = False,
                        band: Optional[Dict] = None):
    """K-buffer via depth peeling: pass 0 through tile_fold's opaque mode,
    passes 1..K-1 through its peel mode, each keeping the best fragment
    strictly below the previous pass's winner, then the reference's
    sequential shade-blend replayed over the layers in submission order
    (replay_layers).  Counterpart of pallas_tile.render_tile_pallas_kbuffer,
    with its exactness contract (ops/kbuffer.py's docstring); LESS_EQUAL
    only.

    Between passes, as pallas_tile.py:1128-1168 does: with
    params.kbuffer_short_circuit a pixel stops peeling behind a visible
    winner flagged opaque (per_tri_extra["opq"], ALPHA blending) or any
    visible winner (NONE blending); pixels of the tile grid's pad band stop
    too; and a pass whose previous winners are all stopped ends the
    peeling.  Passes 1..K-1 shade only the row segments holding a winner
    when they fit params.kbuffer_compact_rows of the frame (bit-exact: the
    shader works per pixel).

    The TPU program makes three choices on the device (lax.cond).  Here
    two are host reads: the empty-pass test before each peel pass (a dead
    pass costs neither a launch nor a shading pass) and each live pass's
    segment list (torch.nonzero; its length decides whether compaction
    fits).  The third, whether the replay needs its deeper rounds, is
    known on the host: it runs one round per pass run.  So a frame
    synchronises at most 2 (K - 1) times beyond the uniform upload.

    fold: tile_fold (the default) or tile_fold_plain; band: a band of a
    sharded frame, as render_tile's.  Returns (color (H, W, 4), depth
    (H, W)), and a stats dict {"kbuffer_saturated_px": pixels whose K-th
    layer holds a fragment} third when with_stats."""
    K = params.kbuffer
    ctx = _prepare_for(tris, fragment_shader, params, fb_depth,
                       per_tri_extra, band)
    fold = fold or tile_fold
    H, W, Hp, Wp = ctx["H"], ctx["W"], ctx["Hp"], ctx["Wp"]
    use_opq = (params.kbuffer_short_circuit and "opq" in ctx["extra_keys"]
               and params.blend_mode == BlendMode.ALPHA)
    none_stop = (params.kbuffer_short_circuit
                 and params.blend_mode == BlendMode.NONE)

    def shade(frag):
        col = fragment_shader(frag, uniforms)
        if use_opq:
            return col, (frag["tri"]["opq"] > 0) & (col[..., 3] > 0)
        if none_stop:
            return col, col[..., 3] > 0
        return col, None

    compact = _compaction(params)

    def shade_layer(gbuf, bi):
        """Shade a peel pass's layer: the live row segments only, when
        they fit; else the whole frame."""
        if compact is not None:
            seg, seg_cap = compact
            nseg = W // seg
            live_seg = (bi[:H, :W] >= 0).reshape(H * nseg, seg).any(1)
            # torch.nonzero's size is dynamic, so this is a host sync; it
            # has no fill entries, so index_copy_ below writes each live
            # segment once and no segment twice.
            with span("sync.peel_segments"):
                idx = torch.nonzero(live_seg).squeeze(1)
            if idx.numel() <= seg_cap:
                kpi = gbuf.shape[0]
                first = (idx // nseg) * Wp + (idx % nseg) * seg
                offs = first[:, None] + torch.arange(seg, device=idx.device)
                sub = gbuf.reshape(kpi, Hp * Wp)[:, offs]   # one gather
                col_s, opq_s = shade(frag_from_planes(ctx, sub))
                col = col_s.new_zeros((H * nseg, seg, 4)).index_copy_(
                    0, idx, col_s).reshape(H, W, 4)
                opq = None
                if opq_s is not None:
                    opq = opq_s.new_zeros((H * nseg, seg)).index_copy_(
                        0, idx, opq_s).reshape(H, W)
                return col, opq
        return shade(frag_from_planes(ctx, gbuf[:, :H, :W]))

    args, kwargs = fold_inputs(ctx)
    with span("tile.fold"):
        gbuf, bd, bi = fold(*args, **kwargs)
    with span("tile.shade"):
        col, opq = shade(frag_from_planes(ctx, gbuf[:, :H, :W]))
    colors, depths, ids = [col], [bd[:H, :W]], [bi[:H, :W]]
    pad_stop = torch.ones((Hp, Wp), dtype=torch.bool, device=bd.device)
    pad_stop[:H, :W] = False
    for _ in range(1, K):
        with span("tile.peel_prev"):
            stop = pad_stop
            if opq is not None:
                stop = pad_stop.clone()
                stop[:H, :W] |= opq
            prev_d = torch.where(stop, DEPTH_CLEAR, bd)
            prev_i = torch.where(stop, -1, bi)
            live = (prev_i >= 0).any()
            with span("sync.peel_live"):
                live = bool(live)
            if not live:
                break
        with span("tile.peel_fold"):
            gbuf, bd, bi = fold(*args, **kwargs, prev_d=prev_d,
                                prev_i=prev_i)
        with span("tile.peel_shade"):
            col, opq = shade_layer(gbuf, bi)
        colors.append(col)
        depths.append(bd[:H, :W])
        ids.append(bi[:H, :W])
    with span("tile.replay"):
        return replay_layers(torch.stack(colors), torch.stack(depths),
                             torch.stack(ids), fb_color, fb_depth, params,
                             with_stats)


def render_tile_kbuffer_single(tris: Dict, fragment_shader: Callable,
                               uniforms: Dict, params: RenderParams,
                               fb_color: torch.Tensor,
                               fb_depth: torch.Tensor,
                               per_tri_extra: Optional[Dict] = None,
                               fold: Optional[Callable] = None,
                               with_stats: bool = False):
    """K-buffer via the single-pass K-deep fold: one tile_fold_kdeep
    launch for all K layers, each shaded over the whole frame, then the
    same replay as render_tile_kbuffer.  Counterpart of
    pallas_tile.render_tile_pallas_kbuffer_single; equal to the peel route
    without the short-circuit's stops (and within one blend ulp of it with
    them).  LESS_EQUAL only.

    The K-deep kernel holds at most MAX_KDEEP slots a pixel (the reference
    takes any K in one pass).  A deeper K-buffer goes through the route
    this one equals, render_tile_kbuffer with kbuffer_short_circuit off:
    the same layers, from K peel passes instead of one fold.

    fold: tile_fold_kdeep (the default) or tile_fold_kdeep_plain; above
    MAX_KDEEP the peel passes run tile_fold, or tile_fold_plain for the
    latter."""
    K = params.kbuffer
    if K < 1:
        raise ValueError(f"the K-deep fold takes kbuffer >= 1, got {K}")
    if K > MAX_KDEEP:
        return render_tile_kbuffer(
            tris, fragment_shader, uniforms,
            params.replace(kbuffer_short_circuit=False), fb_color, fb_depth,
            per_tri_extra=per_tri_extra, with_stats=with_stats,
            fold=tile_fold_plain if fold is tile_fold_kdeep_plain else None)
    ctx = _prepare_for(tris, fragment_shader, params, fb_depth,
                       per_tri_extra)
    H, W, kpi = ctx["H"], ctx["W"], ctx["kpi"]
    args, kwargs = fold_inputs(ctx)
    with span("tile.fold"):
        gbuf, bd, bi = (fold or tile_fold_kdeep)(*args, K=K, **kwargs)
    with span("tile.shade"):
        src = torch.stack([
            fragment_shader(frag_from_planes(
                ctx, gbuf[s * kpi:(s + 1) * kpi, :H, :W]), uniforms)
            for s in range(K)])
    with span("tile.replay"):
        return replay_layers(src, bd[:, :H, :W], bi[:, :H, :W], fb_color,
                             fb_depth, params, with_stats)


def replay_layers(src: torch.Tensor, sd: torch.Tensor, si: torch.Tensor,
                  fb_color: torch.Tensor, fb_depth: torch.Tensor,
                  params: RenderParams, with_stats: bool = False):
    """Submission-order replay of shaded layers (Rasterizer.cs:509-523 +
    Blend :57-65), the counterpart of pallas_tile._replay_layers.

    src (n, H, W, 4) shaded colors, sd (n, H, W) depths, si (n, H, W) int32
    triangle ids (-1: no fragment) of the n <= params.kbuffer layers
    computed; a pixel's ids are distinct.  Round r takes each pixel's r-th
    smallest id and applies the reference's depth test (params.depth_test,
    forward._depth_passes: new >= old under LESS_EQUAL), alpha > 0
    discard and blend against the running buffer, and writes the depth
    unless the test is DISABLED.  Rounds past the n layers would find no
    fragment, so there are n of them.
    with_stats adds {"kbuffer_saturated_px": pixels whose K-th layer holds
    a fragment} (0 unless all K layers were computed)."""
    n = si.shape[0]
    K = params.kbuffer
    none = torch.iinfo(I32).max
    key = torch.where(si >= 0, si, none)
    cur_c, cur_d = fb_color, fb_depth
    depth_writes = params.depth_test != DepthTest.DISABLED
    for r in range(n):
        # Each pixel's smallest id not replayed yet: a masked minimum over
        # the layers, as pallas_tile's K-way selects (a per-pixel sort of
        # the layer axis costs far more on the card).
        sel, pick = key.min(dim=0, keepdim=True)
        if r + 1 < n:
            key = key.scatter(0, pick, none)
        sel_d = sd.gather(0, pick)[0]
        sel_c = src.gather(0, pick[..., None].expand(1, *src.shape[1:]))[0]
        written = (sel[0] != none) \
            & forward._depth_passes(params.depth_test, sel_d, cur_d) \
            & (sel_c[..., 3] > 0)
        cur_c = torch.where(written[..., None],
                            blend(sel_c, cur_c, params.blend_mode), cur_c)
        if depth_writes:
            cur_d = torch.where(written, sel_d, cur_d)
    if not with_stats:
        return cur_c, cur_d
    saturated = (si[K - 1] >= 0).sum(dtype=I32) if n >= K \
        else torch.zeros((), dtype=I32, device=si.device)
    return cur_c, cur_d, {"kbuffer_saturated_px": saturated}
