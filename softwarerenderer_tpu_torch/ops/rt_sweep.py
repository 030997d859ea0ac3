"""Bundle sweep: Möller–Trumbore over each ray bundle's surviving clusters.

Counterpart of ``softwarerenderer_tpu/ops/rt_pallas.py``.  Its Pallas
kernel (``_kernel``) becomes the hand-written CUDA kernel
``csrc/rt_sweep.cu`` behind ``rt_sweep``; ``rt_sweep_plain`` is its plain
PyTorch twin, which the wrapper runs for CPU tensors.  There is no fallback
from one to the other.

Layouts (built by ``build_rt_accel_pl`` and ``_prep``):

  stream  (11, Tp) f32   rows 0-2 v0.xyz, 3-5 e1.xyz, 6-8 e2.xyz of the
                         Morton-ordered triangle slots, row 9 the global
                         triangle id as int32 bits (exact for any id),
                         row 10 the live flag (1.0 live, 0.0 pad or masked);
                         clusters are runs of GROUP = 128 slots.
  rays    (B, 6, R) f32  rows 0-2 origin xyz, 3-5 normalized direction xyz;
                         any R.
  lists   (B, capb) i32  each bundle's surviving cluster ids, front to back
                         by entry time; entries past counts[b] are unused.
  counts  (B,) i32
  t0q     (B, capb) i32  the sorted entry times ×64, floored and clamped to
                         [0, 2^30] (JAX's quantization: t0q / 64 <= t0, so
                         the early exit stays conservative).

The sweep's winner per ray is the lexicographic minimum of (t, global id)
over every listed cluster's live slots where Möller–Trumbore passes, with
t = float32 max and id NOTRI on a miss; in any-hit mode it is the OR of the
passes.  ``raycast_bundles_nearest`` / ``raycast_bundles_any`` keep the
JAX wrappers' contract and result dicts: survivors come from
``rt_accel._bundles_alive_entry``; ``capb=None`` (the default, what the
frame uses) lists every cluster a bundle keeps and can never overflow; an
explicit ``capb`` that some bundle's survivors exceed sends the whole call
to the brute raycast, and the result's ``overflow`` says so.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional, Tuple

import torch
from softwarerenderer_tpu_torch.utils.profiling import span

from softwarerenderer_tpu_torch.ops import rt_accel
from softwarerenderer_tpu_torch.sim.raycast import (
    BIG,
    FACE_MASK_NONE,
    mt_block,
    raycast_batch,
    raycast_batch_bary)
from softwarerenderer_tpu_torch.utils import mathlib as ml

F32 = torch.float32
I32 = torch.int32
NOTRI = 2 ** 30          # "no triangle" id of a miss
GROUP = 128              # triangles per cluster
STREAM_ROWS = 11
GROUP_RAYS = 1024        # rays of one group of `swept` (rt_sweep.cu)
# Rays of one part of a bundle in csrc/rt_sweep.cu: consecutive rays that
# one warp sweeps with its own early exit.
PART_RAYS = 32
# The most (bundle, ray, slot) triples one chunk of the plain twin
# evaluates: each scalar temporary then holds 64 MB of float32.
PLAIN_BLOCK = 1 << 24

# Kernel launches so far: every launch of csrc/rt_sweep.cu, and the any-hit
# ones among them.  chip_smoke.py resets and reads them.
LAUNCHES = 0
ANY_HIT_LAUNCHES = 0


def build_rt_accel_pl(world: Dict) -> Dict:
    """rt_accel.build_rt_accel at GROUP = 128 plus the sweep's (11, Tp)
    triangle stream (module docstring).  Ids stay int32 bits, so there is
    no limit on the triangle count."""
    accel = rt_accel.build_rt_accel(world, group=GROUP)
    Tp = accel["v0"].shape[0]
    dev = accel["v0"].device
    rows = torch.zeros((STREAM_ROWS, Tp), dtype=F32, device=dev)
    rows[0:3] = accel["v0"].T
    rows[3:6] = accel["e1"].T
    rows[6:9] = accel["e2"].T
    rows[9] = accel["perm"].view(F32)
    rows[10] = accel["slot_ok"].to(F32)
    return dict(accel, tri_stream=rows)


def _prep(origins, directions, accel: Dict, slot_mask, capb):
    """The wrappers' prelude: packed normalized rays, the stream with the
    (possibly tri-masked) live flag, each bundle's survivors sorted front
    to back by entry time with their counts and quantized entry times, and
    the overflow predicate (a device bool).  capb = None lists every
    cluster; otherwise it is clamped to the cluster count."""
    nc = int(accel["n_clusters"])
    capb = nc if capb is None else min(int(capb), nc)
    o = origins.to(F32)
    d = ml.safe_normalize(directions.to(F32))
    rays = torch.cat([o.transpose(1, 2), d.transpose(1, 2)], 1).contiguous()
    stream = accel["tri_stream"]
    if slot_mask is not accel["slot_ok"]:
        stream = stream.clone()
        stream[10] = slot_mask.to(F32)
    alive, t0 = rt_accel._bundles_alive_entry(o, d, accel, slot_mask)
    counts = alive.sum(1, dtype=I32)
    keyed = torch.where(alive, t0, BIG)
    order = torch.argsort(keyed, dim=1, stable=True)[:, :capb]
    t0s = keyed.gather(1, order)
    t0q = torch.floor(t0s * 64.0).clamp(0.0, 2.0 ** 30).to(I32)
    overflow = counts.amax() > capb if counts.numel() else \
        torch.zeros((), dtype=torch.bool, device=o.device)
    return (o, d, rays, stream, order.to(I32).contiguous(), counts,
            t0q.contiguous(), overflow)


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous {dtype} {tuple(shape)} "
                         f"on {device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def _entry():
    from softwarerenderer_tpu_torch.kernels import build
    fn = build.load("rt_sweep").rt_sweep_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def bundle_order(counts: torch.Tensor) -> torch.Tensor:
    """The order in which rt_sweep.cu's blocks take the bundles: longest
    survivor list first, equal counts in bundle order (a stable sort), so
    the long lists start in the first wave of blocks, short ones fill the
    tail and the bundles that list nothing come last.  counts (B,) int32;
    returns a permutation of range(B) as int64 on counts' device, with no
    host read.  The sweep does not depend on it: any permutation gives the
    same outputs."""
    return torch.argsort(counts, descending=True, stable=True)


def rt_sweep(rays, stream, lists, counts, t0q, *, any_hit: bool,
             face_mask: int, swept: Optional[torch.Tensor] = None,
             boxes: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
             tested: Optional[torch.Tensor] = None):
    """Sweep every bundle's listed clusters (module docstring layouts).

    Returns (t (B, R) f32, g (B, R) i32): in nearest mode the winner's t
    and global id (float32 max and NOTRI on a miss), in any-hit mode zeros
    and the occlusion flag (1 occluded, 0 clear).  With `swept`, a (B,)
    int32 tensor, each bundle's count of clusters swept is written there:
    the clusters it had to go through before all its rays were done by the
    kernel's early exit, summed over its groups of GROUP_RAYS rays (the
    twin sweeps every listed cluster).  A count above capb sweeps the first
    capb clusters.  CUDA tensors launch csrc/rt_sweep.cu; CPU tensors run
    rt_sweep_plain.

    boxes: (cl_lo, cl_hi), the clusters' (NC, 3) boxes of
    rt_accel.build_rt_accel.  They change no result: with them a part of a
    bundle (PART_RAYS rays) skips the clusters its own rays cannot reach.
    tested: a (B,) int32 tensor that takes each bundle's count of (part,
    cluster) pairs whose triangles were tested; without skipping that is
    swept times the parts of a group."""
    global LAUNCHES, ANY_HIT_LAUNCHES
    if rays.device.type == "cpu":
        return rt_sweep_plain(rays, stream, lists, counts, t0q,
                              any_hit=any_hit, face_mask=face_mask,
                              swept=swept, boxes=boxes, tested=tested)
    if rays.device.type != "cuda":
        raise ValueError(f"rt_sweep runs on cuda or cpu, not {rays.device}")
    (out_t, out_g), call, (_order, groups, counted) = sweep_launch_args(
        rays, stream, lists, counts, t0q, any_hit=any_hit,
        face_mask=face_mask, swept=swept, boxes=boxes, tested=tested)
    err = _entry()(*call, torch.cuda.current_stream(rays.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rt_sweep kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    if any_hit:
        ANY_HIT_LAUNCHES += 1
    if swept is not None:
        torch.sum(groups, 1, dtype=I32, out=swept)
    if tested is not None:
        tested.copy_(counted)
    return out_t, out_g


def sweep_launch_args(rays, stream, lists, counts, t0q, *, any_hit: bool,
                      face_mask: int, swept=None, boxes=None, tested=None):
    """What rt_sweep hands csrc/rt_sweep.cu, on rays' device: checks the
    inputs, computes the bundle order and allocates the outputs and, for
    `swept` and `tested`, the zeroed counters the kernel adds to.  Returns
    ((out_t, out_g), the entry point's arguments up to the stream, (bundle
    order, per-group swept counters or None, tested counter or None))."""
    dev = rays.device
    B, six, R = rays.shape
    Tp = stream.shape[1]
    capb = lists.shape[1]
    _check("rays", rays, F32, (B, 6, R), dev)
    _check("stream", stream, F32, (STREAM_ROWS, Tp), dev)
    _check("lists", lists, I32, (B, capb), dev)
    _check("counts", counts, I32, (B,), dev)
    _check("t0q", t0q, I32, (B, capb), dev)
    if Tp % GROUP:
        raise ValueError(f"stream width {Tp} is not a multiple of {GROUP}")
    box_ptrs = (None, None)
    if boxes is not None:
        for name, box in zip(("cl_lo", "cl_hi"), boxes):
            _check(name, box, F32, (Tp // GROUP, 3), dev)
        box_ptrs = tuple(box.data_ptr() for box in boxes)
    groups = counted = None
    if swept is not None:
        _check("swept", swept, I32, (B,), dev)
        groups = torch.zeros((B, -(-R // GROUP_RAYS)), dtype=I32, device=dev)
    if tested is not None:
        _check("tested", tested, I32, (B,), dev)
        counted = torch.zeros((B,), dtype=I32, device=dev)
    order = bundle_order(counts)
    out_t = torch.empty((B, R), dtype=F32, device=dev)
    out_g = torch.empty((B, R), dtype=I32, device=dev)
    call = (rays.data_ptr(), stream.data_ptr(), lists.data_ptr(),
            counts.data_ptr(), t0q.data_ptr(), order.data_ptr(), *box_ptrs,
            out_t.data_ptr(), out_g.data_ptr(),
            None if groups is None else groups.data_ptr(),
            None if counted is None else counted.data_ptr(),
            B, R, Tp, capb, int(bool(any_hit)), int(face_mask))
    return (out_t, out_g), call, (order, groups, counted)


def rt_sweep_plain(rays, stream, lists, counts, t0q, *, any_hit: bool,
                   face_mask: int, swept: Optional[torch.Tensor] = None,
                   boxes=None, tested: Optional[torch.Tensor] = None):
    """rt_sweep in plain PyTorch: same inputs, outputs and rounding, no
    early exit and no skipping (`boxes` is not read: every listed cluster
    is tested against every ray, so `tested` is the listed clusters times
    the parts of a bundle).  Each chunk of bundles gathers its listed
    clusters' slots (slots past a bundle's count masked), runs
    Möller–Trumbore over (bundles, rays, slots), and reduces t with amin
    and then the id with amin among the slots at the best t; the t
    returned is the winning slot's own (a tie of +0.0 and -0.0 keeps the
    winner's sign)."""
    B, _, R = rays.shape
    dev = rays.device
    capb = lists.shape[1]
    out_t = torch.zeros((B, R), dtype=F32, device=dev)
    out_g = torch.zeros((B, R), dtype=I32, device=dev)
    if not any_hit:
        out_t.fill_(BIG)
        out_g.fill_(NOTRI)
    counts = counts.clamp(max=capb)
    if swept is not None:
        swept.copy_(counts * -(-R // GROUP_RAYS))
    if tested is not None:
        tested.copy_(counts * -(-R // PART_RAYS))
    ids = stream[9].contiguous().view(I32)
    slot = torch.arange(GROUP, device=dev)
    cmax = counts.amax().item() if B else 0
    if cmax == 0:
        return out_t, out_g
    nb = max(1, PLAIN_BLOCK // (R * cmax * GROUP))
    for b0 in range(0, B, nb):
        b1 = min(B, b0 + nb)
        cnt = counts[b0:b1].long()
        k = int(cnt.amax().item())
        if k == 0:
            continue
        listed = torch.arange(k, device=dev) < cnt[:, None]     # (nb, k)
        cols = (lists[b0:b1, :k].long().clamp(min=0)[..., None] * GROUP
                + slot).reshape(b1 - b0, k * GROUP)              # (nb, K)
        tri = stream[:, cols]                                   # (11, nb, K)
        ok_slot = (tri[10] > 0) & listed.repeat_interleave(GROUP, 1)
        v0 = tri[0:3].permute(1, 2, 0)[:, None]                 # (nb,1,K,3)
        e1 = tri[3:6].permute(1, 2, 0)[:, None]
        e2 = tri[6:9].permute(1, 2, 0)[:, None]
        o = rays[b0:b1, 0:3].transpose(1, 2)[:, :, None]        # (nb,R,1,3)
        d = rays[b0:b1, 3:6].transpose(1, 2)[:, :, None]
        ok, t, _u, _v = mt_block(o, d, v0, e1, e2, face_mask)
        ok &= ok_slot[:, None, :]
        if any_hit:
            out_g[b0:b1] = ok.any(-1).to(I32)
            continue
        tm = torch.where(ok, t, BIG)
        tb = tm.amin(-1)                                        # (nb, R)
        at = ok & (tm == tb[..., None])
        sid = ids[cols][:, None, :]                             # (nb, 1, K)
        gid = torch.where(at, sid, NOTRI).amin(-1)
        # Each global id has one slot, so exactly one slot wins a hit.
        win = at & (sid == gid[..., None])
        out_t[b0:b1] = torch.where(win, tm, BIG).amin(-1)
        out_g[b0:b1] = gid
    return out_t, out_g


def _read_overflow(overflow: torch.Tensor) -> bool:
    """An explicit capb's overflow flag, read on the host."""
    with span("sync.rt_overflow"):
        return bool(overflow)


def raycast_bundles_nearest(origins, directions, world: Dict, accel: Dict,
                            *, capb=None, face_mask: int = FACE_MASK_NONE,
                            tri_mask=None, sweep: Optional[Callable] = None):
    """Nearest hit of B bundles × R rays ((B, R, 3) origins and
    directions): raycast_batch's result dict with (B, R) leaves, plus the
    winner's barycentrics "u"/"v", "n_pairs" (listed (bundle, cluster)
    pairs, a device int) and "overflow" (a device bool).  sweep: the sweep
    to run, rt_sweep by default; rt_sweep_plain casts through the twin."""
    sweep = sweep or rt_sweep
    slot_mask = rt_accel._slot_mask(accel, tri_mask)
    with span("rt.prep"):
        (o, d, rays, stream, lists, counts, t0q,
         overflow) = _prep(origins, directions, accel, slot_mask, capb)
    if capb is not None and _read_overflow(overflow):
        B, R = o.shape[:2]
        res = raycast_batch_bary(o.reshape(-1, 3), d.reshape(-1, 3),
                                 world, face_mask, tri_mask)
        out = {k: x.reshape((B, R) + x.shape[1:]) for k, x in res.items()}
    else:
        with span("rt.sweep_nearest"):
            tbest, g = sweep(rays, stream, lists, counts, t0q, any_hit=False,
                             face_mask=face_mask,
                             boxes=(accel["cl_lo"], accel["cl_hi"]))
        with span("rt.winner"):
            hit = g < NOTRI
            wtri = torch.where(hit, g, 0).long()
            if "geom_table" in world:
                gt = world["geom_table"][wtri]                  # (B, R, 18)
                wv0, we1, we2 = gt[..., 0:3], gt[..., 3:6], gt[..., 6:9]
                n0, n1, n2 = gt[..., 9:12], gt[..., 12:15], gt[..., 15:18]
            else:
                wv0 = world["v0"][wtri]
                we1 = world["v1"][wtri] - wv0
                we2 = world["v2"][wtri] - wv0
                n0, n1, n2 = (world[k][wtri] for k in ("n0", "n1", "n2"))
            _ok, _t, u, v = mt_block(o, d, wv0, we1, we2, face_mask)
            w = 1.0 - u - v
            normal = ml.safe_normalize(n0 * w[..., None] + n1 * u[..., None]
                                       + n2 * v[..., None])
            dist = torch.where(hit, tbest, BIG)
            point = o + d * torch.where(hit, dist, 0.0)[..., None]
            out = {"hit": hit, "distance": dist,
                   "point": torch.where(hit[..., None], point, 0.0),
                   "normal": torch.where(hit[..., None], normal, 0.0),
                   "tri": wtri.to(I32), "u": u, "v": v}
    out["n_pairs"] = counts.sum()
    out["overflow"] = overflow
    return out


def raycast_bundles_any(origins, directions, world: Dict, accel: Dict,
                        *, capb=None, face_mask: int = FACE_MASK_NONE,
                        tri_mask=None, sweep: Optional[Callable] = None):
    """Occlusion of B bundles × R rays: {"hit": (B, R) bool, "n_pairs",
    "overflow"}, "hit" equal to raycast_batch's; sweep as in
    raycast_bundles_nearest."""
    sweep = sweep or rt_sweep
    slot_mask = rt_accel._slot_mask(accel, tri_mask)
    with span("rt.prep"):
        (o, d, rays, stream, lists, counts, t0q,
         overflow) = _prep(origins, directions, accel, slot_mask, capb)
    if capb is not None and _read_overflow(overflow):
        B, R = o.shape[:2]
        hit = raycast_batch(o.reshape(-1, 3), d.reshape(-1, 3), world,
                            face_mask=face_mask,
                            tri_mask=tri_mask)["hit"].reshape(B, R)
    else:
        with span("rt.sweep_any"):
            _t, g = sweep(rays, stream, lists, counts, t0q, any_hit=True,
                          face_mask=face_mask,
                          boxes=(accel["cl_lo"], accel["cl_hi"]))
        hit = g > 0
    return {"hit": hit, "n_pairs": counts.sum(), "overflow": overflow}
