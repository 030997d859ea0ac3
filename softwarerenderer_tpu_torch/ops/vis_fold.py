"""The binned visibility fold of the deferred route, K5.

Counterpart of ``softwarerenderer_tpu/ops/pallas_raster.py``: for every
pixel, the (depth, triangle id) winner under LESS_EQUAL (the largest
depth, later ids winning ties, a fragment at exactly the seed's depth
beating the seed) over the tile's global list and then its binned segment,
seeded with the framebuffer depth, with no payload and no resolve.
``pallas_raster._fold_kernel`` becomes the hand-written CUDA kernel
``csrc/vis_fold.cu`` behind ``vis_fold``, which launches it for CUDA
tensors and runs the plain PyTorch twin ``visibility_fold_plain`` for CPU
tensors; there is no fallback from one to the other.  The kernel cuts each
tile's list into parts of ``part_len`` triangles, folds the parts of a
long list on several blocks and merges them with 64-bit atomics; its
plan kernel builds the work list on the device, and ``fold_items`` is that
list on either device (the plan kernel for CUDA tensors, its plain twin
for CPU tensors).

``visibility_fold`` is a visibility_fn of ``raster.render_deferred``
(``pallas_raster.visibility_pallas``'s contract): it bins the triangles
with ``params.tile_h`` (uncapped, unlike the tile kernel's 32) and
``params.tile_w``, takes the set-up rows of ``raster.setup_rows`` (1/area
zeroed for invalid slots) and folds them.  A NaN fragment never wins,
where the TPU kernel's chunk-wide max lets one void its whole 128-lane
chunk at that pixel.

A band (``visibility_fold``'s row offset, or a band of a sharded frame,
``parallel.sharding``) folds through a tile origin map (``origin``: each
storage tile's screen (y0, x0), ``binning.tile_pixels``; a contiguous band
at a row offset is ``binning.band_origin``), which changes where a pixel
is evaluated, never where it is stored.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional

import torch

from softwarerenderer_tpu_torch.config import DepthTest, RenderParams
from softwarerenderer_tpu_torch.ops import binning
from softwarerenderer_tpu_torch.ops.tile_raster import (BLOCK_PX, N_SETUP,
                                                       check_tensor,
                                                       tile_order)

F32 = torch.float32
I32 = torch.int32
INT_MAX = 2 ** 31 - 1

# K5 launches so far, without a tile origin map and with one (a band of a
# sharded frame); chip_smoke.py resets and reads them to show that a frame
# went through the kernel.
VIS_LAUNCHES = 0
VIS_MAPPED_LAUNCHES = 0
# Triangles a part of a tile's list holds, the kernel's default: the fastest
# of chip_smoke.py's phase 14 part lengths on the 1080p bench frame (PERF.md
# section 6).
PART_LEN = 512

# The kernel's scratch per (device, stream, frame and tile shape): keys
# (Hp * Wp,) int64, arrivals (tiles * blocks,) int32 and work counters
# (2,) int32, zero between launches; the work list (tiles + 1,) int32.
_SCRATCH: Dict = {}


def visibility_fold_plain(fbd, setup, order, n_global, sorted_tri, starts,
                          counts, *, tile_h, tile_w, origin=None):
    """vis_fold in plain PyTorch: same inputs, same outputs, same rounding
    (binning.fold_binned under LESS_EQUAL)."""
    return binning.fold_binned(fbd, setup, order, n_global, sorted_tri,
                               starts, counts, tile_h=tile_h, tile_w=tile_w,
                               mode=DepthTest.LESS_EQUAL, origin=origin)


def fold_items(n_global, counts, part_len: int, blocks_per_tile: int):
    """csrc/vis_fold.cu's work list, with no host read: (tiles (ntiles,)
    int64, first (ntiles + 1,) int32) on counts' device.

    Tile t's list is its n_global globals and then its counts[t] segment
    entries, cut into max(1, ceil(len / part_len)) parts of part_len; each
    part of each of its blocks of BLOCK_PX pixels is one work item.  Tiles
    take their items longest list first (tiles = tile_raster.tile_order):
    the tile at position j of that order owns items [first[j],
    first[j + 1]), and its item first[j] + e is part e // blocks_per_tile,
    block e % blocks_per_tile.  first[-1] is the number of items.  CUDA
    tensors build first with the kernel's own plan kernel, CPU tensors with
    these tensor ops, its plain twin."""
    tiles = tile_order(counts)
    if counts.device.type == "cuda":
        first = torch.empty(counts.numel() + 1, dtype=I32,
                            device=counts.device)
        fn = _entry("vis_fold_plan_launch", [ctypes.c_void_p] * 3
                    + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
        err = fn(tiles.data_ptr(), counts.data_ptr(), n_global.data_ptr(),
                 counts.numel(), part_len, blocks_per_tile, first.data_ptr(),
                 torch.cuda.current_stream(counts.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"vis_fold plan launch failed: CUDA error "
                               f"{err}")
        return tiles, first
    lens = counts.long() + n_global.long()
    parts = ((lens + part_len - 1) // part_len).clamp(min=1)
    first = torch.nn.functional.pad(
        torch.cumsum(parts[tiles] * blocks_per_tile, 0), (1, 0))
    return tiles, first.to(I32)


def blocks_per_sm(tile_w: int, origin: bool = False) -> int:
    """Blocks of csrc/vis_fold.cu's fold an SM of the current card holds
    (the occupancy API; the persistent grid is this many an SM), with a
    tile origin map or without."""
    fn = _entry("vis_fold_blocks_per_sm", [ctypes.c_int] * 2)
    out = fn(int((BLOCK_PX // 4) % tile_w == 0), int(origin))
    if out <= 0:
        raise RuntimeError(f"vis_fold occupancy query failed: {out}")
    return out


def _scratch(dev, stream, Hp: int, Wp: int, ntiles: int, blocks: int):
    key = (dev, stream, Hp, Wp, ntiles, blocks)
    if key not in _SCRATCH:
        _SCRATCH[key] = (
            torch.zeros(Hp * Wp, dtype=torch.int64, device=dev),
            torch.zeros(ntiles * blocks, dtype=I32, device=dev),
            torch.zeros(2, dtype=I32, device=dev),
            torch.empty(ntiles + 1, dtype=I32, device=dev))
    return _SCRATCH[key]


def _entry(name: str = "vis_fold_launch", argtypes=None):
    from softwarerenderer_tpu_torch.kernels import build
    fn = getattr(build.load("vis_fold"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes or [ctypes.c_void_p] * 15 \
            + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def vis_fold(fbd, setup, order, n_global, sorted_tri, starts, counts, *,
             tile_h, tile_w, part_len=PART_LEN, origin=None):
    """The LESS_EQUAL winner of every pixel of the padded (Hp, Wp) tiles.

    fbd (Hp, Wp) f32 seeds each pixel at id -1; setup (N, 10) f32 set-up
    rows; order (N,) i32 with the n_global (1,) i32 globals first;
    sorted_tri (L,), starts and counts (ntiles,) i32 each tile's segment
    (binning.bin_triangles).  Pixel (x, y) is evaluated at screen (x, y),
    or with origin, an (ntiles, 2) int32 map of each tile's screen (y0,
    x0), at its tile's origin (binning.tile_pixels).  Returns (best_d
    (Hp, Wp) f32, best_i (Hp, Wp) i32, -1 where the seed kept the pixel).
    CUDA tensors launch csrc/vis_fold.cu, which builds its work list
    (fold_items) and folds lists cut into parts of part_len triangles; CPU
    tensors run visibility_fold_plain.  The parts do not show in the
    outputs."""
    global VIS_LAUNCHES, VIS_MAPPED_LAUNCHES
    if part_len < 1:
        raise ValueError(f"part_len must be >= 1, got {part_len}")
    if fbd.device.type == "cpu":
        return visibility_fold_plain(fbd, setup, order, n_global,
                                     sorted_tri, starts, counts,
                                     tile_h=tile_h, tile_w=tile_w,
                                     origin=origin)
    if fbd.device.type != "cuda":
        raise ValueError(f"vis_fold runs on cuda or cpu, not {fbd.device}")
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
    if origin is not None:
        check_tensor("origin", origin, I32, (ntx * nty, 2), dev)
    if setup.data_ptr() % 8:
        raise ValueError("setup must start on an 8-byte boundary")
    ntiles = ntx * nty
    blocks = -(-tile_h * tile_w // BLOCK_PX)
    # The most items any bins of these shapes can make must fit an int.
    most_parts = ntiles + (ntiles * n + sorted_tri.numel()) // part_len
    if most_parts * blocks > INT_MAX:
        raise ValueError(f"part_len {part_len} makes too many work items")
    tiles = tile_order(counts)
    stream = torch.cuda.current_stream(dev).cuda_stream
    keys, arrivals, work, first = _scratch(dev, stream, Hp, Wp, ntiles,
                                           blocks)
    best_d = torch.empty((Hp, Wp), dtype=F32, device=dev)
    best_i = torch.empty((Hp, Wp), dtype=I32, device=dev)
    err = _entry()(fbd.data_ptr(), setup.data_ptr(), order.data_ptr(),
                   n_global.data_ptr(), sorted_tri.data_ptr(),
                   starts.data_ptr(), counts.data_ptr(), tiles.data_ptr(),
                   None if origin is None else origin.data_ptr(),
                   first.data_ptr(), best_d.data_ptr(), best_i.data_ptr(),
                   keys.data_ptr(), arrivals.data_ptr(), work.data_ptr(),
                   ntx, nty, tile_h, tile_w, part_len, stream)
    if err != 0:
        raise RuntimeError(f"vis_fold kernel launch failed: CUDA error {err}")
    if origin is None:
        VIS_LAUNCHES += 1
    else:
        VIS_MAPPED_LAUNCHES += 1
    return best_d, best_i


def visibility_fold(tris: Dict, params: RenderParams,
                    chunk: Optional[int] = None,
                    init_depth: Optional[torch.Tensor] = None,
                    row_offset=0, *, fold: Optional[Callable] = None):
    """A visibility_fn of raster.render_deferred running K5: (best_depth
    (H, W) f32, best_tri (H, W) i32) of the band of params.height rows at
    screen row row_offset (folded through its tile origin map), seeded
    with init_depth.  LESS_EQUAL only.
    chunk is the TPU kernel's DMA size and changes nothing here.  fold:
    vis_fold (the default) or visibility_fold_plain."""
    if params.depth_test != DepthTest.LESS_EQUAL:
        raise NotImplementedError("the visibility fold supports LESS_EQUAL; "
                                  "binning.visibility_binned folds the "
                                  "other monotone depth tests")
    args, kwargs = binning.fold_inputs(tris, params, params.tile_h,
                                       params.tile_w, params.span_cap,
                                       init_depth, row_offset)
    best_d, best_i = (fold or vis_fold)(*args, **kwargs)
    H, W = params.height, params.width
    return best_d[:H, :W], best_i[:H, :W]


def make_visibility_fold(fold: Optional[Callable] = None):
    """visibility_fold as a visibility_fn, through `fold` (vis_fold by
    default; visibility_fold_plain renders through the twin)."""
    def fn(tris, params, chunk=None, init_depth=None, row_offset=0):
        return visibility_fold(tris, params, chunk, init_depth, row_offset,
                               fold=fold)
    return fn
