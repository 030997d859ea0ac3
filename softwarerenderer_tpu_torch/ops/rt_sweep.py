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
from typing import Callable, Dict, Optional

import torch
from torch.profiler import record_function

from softwarerenderer_tpu_torch.ops import rt_accel
from softwarerenderer_tpu_torch.sim import raycast as rc
from softwarerenderer_tpu_torch.utils import mathlib as ml

F32 = torch.float32
I32 = torch.int32
BIG = rc.BIG
NOTRI = 2 ** 30          # "no triangle" id of a miss
GROUP = 128              # triangles per cluster
STREAM_ROWS = 11
GROUP_RAYS = 1024        # rays one block holds at a time (rt_sweep.cu)
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
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def rt_sweep(rays, stream, lists, counts, t0q, *, any_hit: bool,
             face_mask: int, swept: Optional[torch.Tensor] = None):
    """Sweep every bundle's listed clusters (module docstring layouts).

    Returns (t (B, R) f32, g (B, R) i32): in nearest mode the winner's t
    and global id (float32 max and NOTRI on a miss), in any-hit mode zeros
    and the occlusion flag (1 occluded, 0 clear).  With `swept`, a (B,)
    int32 tensor, each bundle's count of clusters swept is written there
    (the kernel stops early, summed over its groups of GROUP_RAYS rays; the
    twin sweeps every listed cluster).  A count above capb sweeps the first
    capb clusters.  CUDA tensors launch csrc/rt_sweep.cu; CPU tensors run
    rt_sweep_plain."""
    global LAUNCHES, ANY_HIT_LAUNCHES
    if rays.device.type == "cpu":
        return rt_sweep_plain(rays, stream, lists, counts, t0q,
                              any_hit=any_hit, face_mask=face_mask,
                              swept=swept)
    if rays.device.type != "cuda":
        raise ValueError(f"rt_sweep runs on cuda or cpu, not {rays.device}")
    dev = rays.device
    B, six, R = rays.shape
    Tp = stream.shape[1]
    capb = lists.shape[1]
    _check("rays", rays, F32, (B, 6, R), dev)
    _check("stream", stream, F32, (STREAM_ROWS, Tp), dev)
    _check("lists", lists, I32, (B, capb), dev)
    _check("counts", counts, I32, (B,), dev)
    _check("t0q", t0q, I32, (B, capb), dev)
    if swept is not None:
        _check("swept", swept, I32, (B,), dev)
    if Tp % GROUP:
        raise ValueError(f"stream width {Tp} is not a multiple of {GROUP}")
    out_t = torch.empty((B, R), dtype=F32, device=dev)
    out_g = torch.empty((B, R), dtype=I32, device=dev)
    err = _entry()(rays.data_ptr(), stream.data_ptr(), lists.data_ptr(),
                   counts.data_ptr(), t0q.data_ptr(), out_t.data_ptr(),
                   out_g.data_ptr(),
                   None if swept is None else swept.data_ptr(),
                   B, R, Tp, capb, int(bool(any_hit)), int(face_mask),
                   torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rt_sweep kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    if any_hit:
        ANY_HIT_LAUNCHES += 1
    return out_t, out_g


def rt_sweep_plain(rays, stream, lists, counts, t0q, *, any_hit: bool,
                   face_mask: int, swept: Optional[torch.Tensor] = None):
    """rt_sweep in plain PyTorch: same inputs, outputs and rounding, no
    early exit.  Each chunk of bundles gathers its listed clusters' slots
    (slots past a bundle's count masked), runs Möller–Trumbore over
    (bundles, rays, slots), and reduces t with amin and then the id with
    amin among the slots at the best t; the t returned is the winning
    slot's own (a tie of +0.0 and -0.0 keeps the winner's sign)."""
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
        ok, t, _u, _v = rc.mt_block(o, d, v0, e1, e2, face_mask)
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


def _masks(accel: Dict, tri_mask):
    slot_mask = accel["slot_ok"]
    if tri_mask is not None:
        slot_mask = slot_mask & tri_mask.to(torch.bool)[accel["perm"].long()]
    return slot_mask


def raycast_bundles_nearest(origins, directions, world: Dict, accel: Dict,
                            *, capb=None, face_mask: int = rc.FACE_MASK_NONE,
                            tri_mask=None, sweep: Optional[Callable] = None):
    """Nearest hit of B bundles × R rays ((B, R, 3) origins and
    directions): raycast_batch's result dict with (B, R) leaves, plus the
    winner's barycentrics "u"/"v", "n_pairs" (listed (bundle, cluster)
    pairs, a device int) and "overflow" (a device bool).  sweep: the sweep
    to run, rt_sweep by default; rt_sweep_plain casts through the twin."""
    sweep = sweep or rt_sweep
    slot_mask = _masks(accel, tri_mask)
    with record_function("rt.prep"):
        (o, d, rays, stream, lists, counts, t0q,
         overflow) = _prep(origins, directions, accel, slot_mask, capb)
    if capb is not None and bool(overflow):
        B, R = o.shape[:2]
        res = rc.raycast_batch_bary(o.reshape(-1, 3), d.reshape(-1, 3),
                                    world, face_mask, tri_mask)
        out = {k: x.reshape((B, R) + x.shape[1:]) for k, x in res.items()}
    else:
        with record_function("rt.sweep_nearest"):
            tbest, g = sweep(rays, stream, lists, counts, t0q, any_hit=False,
                             face_mask=face_mask)
        with record_function("rt.winner"):
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
            _ok, _t, u, v = rc.mt_block(o, d, wv0, we1, we2, face_mask)
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
                        *, capb=None, face_mask: int = rc.FACE_MASK_NONE,
                        tri_mask=None, sweep: Optional[Callable] = None):
    """Occlusion of B bundles × R rays: {"hit": (B, R) bool, "n_pairs",
    "overflow"}, "hit" equal to raycast_batch's; sweep as in
    raycast_bundles_nearest."""
    sweep = sweep or rt_sweep
    slot_mask = _masks(accel, tri_mask)
    with record_function("rt.prep"):
        (o, d, rays, stream, lists, counts, t0q,
         overflow) = _prep(origins, directions, accel, slot_mask, capb)
    if capb is not None and bool(overflow):
        B, R = o.shape[:2]
        hit = rc.raycast_batch(o.reshape(-1, 3), d.reshape(-1, 3), world,
                               face_mask=face_mask,
                               tri_mask=tri_mask)["hit"].reshape(B, R)
    else:
        with record_function("rt.sweep_any"):
            _t, g = sweep(rays, stream, lists, counts, t0q, any_hit=True,
                          face_mask=face_mask)
        hit = g > 0
    return {"hit": hit, "n_pairs": counts.sum(), "overflow": overflow}
