"""Ray-tracing acceleration: Morton-clustered triangles and conservative
ray-bundle culling.

Counterpart of the parts of ``softwarerenderer_tpu/ops/rt_accel.py`` that
the bundle sweep (``ops/rt_sweep.py``) runs on:

  * ``build_rt_accel``: triangles sorted by the Morton code of their world
    centroid, so each run of ``group`` slots is spatially tight, with one
    AABB per cluster;
  * ``_bundles_alive_entry``: per bundle of rays, which clusters any ray of
    the bundle could reach (an interval slab test against the bundle's
    origin and direction AABBs) and the earliest time it could enter each.

JAX's ``_mt_block`` (Möller–Trumbore over broadcastable blocks) is
``sim.raycast.mt_block`` here, shared with ``raycast_batch``.

JAX's XLA pair sweep (``_pair_table``, ``_pair_sweep``,
``raycast_bundles_nearest/any``) and the per-chunk cap ladder
(``raycast_bundle_culled``) are not ported: they are JAX's route where
Pallas cannot run, and here the sweep kernel's plain twin takes that place
on the CPU.
"""

from __future__ import annotations

from typing import Dict

import torch

from softwarerenderer_tpu_torch.sim import raycast as rc

F32 = torch.float32
I32 = torch.int32
BIG = rc.BIG


def _morton3(q: torch.Tensor) -> torch.Tensor:
    """Interleave three 10-bit integer coordinates (N, 3) int32 -> (N,)
    int32 Morton codes (x bit i -> code bit 3i, y -> 3i+1, z -> 3i+2)."""
    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x
    x, y, z = q[:, 0], q[:, 1], q[:, 2]
    return spread(x) | (spread(y) << 1) | (spread(z) << 2)


def build_rt_accel(world: Dict, group: int = 64) -> Dict:
    """Cluster the collision world's triangles for bundle culling.

    `world` is sim.raycast.build_collision_world's output.  Returns, on the
    world's device:

      perm      (Tp,)  int32 slot -> global triangle id (pad slots -> 0)
      slot_ok   (Tp,)  bool pad mask
      v0/e1/e2  (Tp, 3) f32 permuted corners / edge vectors
      cl_lo/hi  (NC, 3) f32 cluster AABBs (pad slots excluded)
      group, n_clusters  (ints)
    """
    v0, v1, v2 = world["v0"], world["v1"], world["v2"]
    dev = v0.device
    T = v0.shape[0]
    Tp = -(-T // group) * group

    cent = (v0 + v1 + v2) * (1.0 / 3.0)
    lo = cent.amin(0)
    hi = cent.amax(0)
    span = torch.maximum(hi - lo, torch.full((), 1e-20, device=dev))
    q = ((cent - lo) / span * 1023.0).to(I32).clamp(0, 1023)
    perm = torch.argsort(_morton3(q), stable=True).to(I32)      # (T,)

    pad = Tp - T
    perm = torch.nn.functional.pad(perm, (0, pad))               # pad -> 0
    slot_ok = torch.arange(Tp, device=dev) < T

    pv0, pv1, pv2 = v0[perm.long()], v1[perm.long()], v2[perm.long()]
    nc = Tp // group
    corners = torch.stack([pv0, pv1, pv2], dim=1).reshape(nc, group, 3, 3)
    okc = slot_ok.reshape(nc, group, 1, 1)
    cl_lo = torch.where(okc, corners, BIG).amin(dim=(1, 2))
    cl_hi = torch.where(okc, corners, -BIG).amax(dim=(1, 2))
    return {
        "perm": perm, "slot_ok": slot_ok,
        "v0": pv0, "e1": pv1 - pv0, "e2": pv2 - pv0,
        "cl_lo": cl_lo, "cl_hi": cl_hi,
        "group": group, "n_clusters": nc,
    }


def _reach_ge(x0, x1, s0, s1, c):
    """t-interval [t0, t1] on which max over the bundle of (x + t*s) can be
    >= c, for origin interval [x0, x1] and slope interval [s0, s1], t >= 0.
    The max trajectory is x1 + t*s1.  Conservative; NaN propagates."""
    up = s1 > 0
    dn = s1 < 0
    at0 = x1 >= c
    tc = (c - x1) / torch.where(s1 == 0, 1.0, s1)
    t0 = torch.where(at0, 0.0, torch.where(up, tc, BIG))
    t1 = torch.where(at0 & dn, tc, torch.where(at0 | up, BIG, -BIG))
    return t0, t1


def _reach_le(x0, x1, s0, s1, c):
    """t-interval on which min over the bundle of (x + t*s) can be <= c.
    The min trajectory is x0 + t*s0.  (Mirror of _reach_ge.)"""
    return _reach_ge(-x1, -x0, -s1, -s0, -c)


def _bundles_alive_entry(origins, directions, accel: Dict, slot_mask):
    """((B, NC) bool survival, (B, NC) f32 conservative entry time).

    Per bundle the origin and direction AABBs come from min/max over its
    rays, and the slab test broadcasts (B, 1) against (1, NC).  Clusters
    with no maskable triangle are dead for every bundle.  A bundle whose
    origins are NaN keeps no cluster: torch.maximum/minimum and amin/amax
    propagate NaN, and every comparison with NaN is false."""
    o, d = origins, directions                          # (B, R, 3)
    olo, ohi = o.amin(1), o.amax(1)                     # (B, 3)
    dlo, dhi = d.amin(1), d.amax(1)
    cl_lo, cl_hi = accel["cl_lo"], accel["cl_hi"]       # (NC, 3)
    B, nc = o.shape[0], cl_lo.shape[0]
    t0 = torch.zeros((B, nc), dtype=F32, device=o.device)
    t1 = torch.full((B, nc), BIG, dtype=F32, device=o.device)
    for a in range(3):
        args = (olo[:, a:a + 1], ohi[:, a:a + 1], dlo[:, a:a + 1],
                dhi[:, a:a + 1])
        g0, g1 = _reach_ge(*args, cl_lo[None, :, a])
        l0, l1 = _reach_le(*args, cl_hi[None, :, a])
        t0 = torch.maximum(t0, torch.maximum(g0, l0))
        t1 = torch.minimum(t1, torch.minimum(g1, l1))
    alive = t0 <= t1
    nonempty = slot_mask.reshape(accel["n_clusters"], accel["group"]).any(1)
    return alive & nonempty[None, :], t0
