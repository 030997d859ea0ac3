"""The collectives of the multi-device layer, on torch.distributed.

One process runs each rank.  Under NCCL (a card a rank) every collective
here takes the rank's CUDA tensors.  Under gloo (the CPU tests, or several
ranks sharing one card, which NCCL refuses) PyTorch's backend table lists
CUDA tensors for ``all_reduce`` and ``broadcast`` only, so the gather and
the ring's point-to-point exchange of CUDA tensors go through pinned host
buffers here, explicitly, and ``HOST_STAGED`` counts each such call by
collective (chip_smoke.py's phase 25 logs it).  No collective reads a
value on the host to size anything: every shape follows from the mesh and
the frame's parameters.
"""

from __future__ import annotations

import collections
from typing import List, Sequence

import torch
import torch.distributed as dist

# Collective calls whose CUDA tensors went through host buffers (gloo).
HOST_STAGED: collections.Counter = collections.Counter()


def _host_staged(t: torch.Tensor, group, name: str) -> bool:
    """True, and counted, when `name` on t must stage through the host:
    a CUDA tensor under gloo."""
    staged = t.device.type != "cpu" and dist.get_backend(group) == "gloo"
    if staged:
        HOST_STAGED[name] += 1
    return staged


def _pinned(t: torch.Tensor) -> torch.Tensor:
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return out.copy_(t)


def all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    """t reduced over `group` with op (dist.ReduceOp), in place; every
    backend takes the rank's tensor as it is."""
    if dist.get_world_size(group) > 1:
        dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """(n, *t.shape): every rank's t in the group's rank order, on t's
    device."""
    n = dist.get_world_size(group)
    t = t.contiguous()
    if n == 1:
        return t[None]
    if _host_staged(t, group, "all_gather") or t.device.type == "cpu":
        host = _pinned(t) if t.device.type != "cpu" else t
        parts = [torch.empty_like(host) for _ in range(n)]
        dist.all_gather(parts, host, group=group)
        return torch.stack(parts).to(t.device)
    out = torch.empty((n, *t.shape), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t, group=group)
    return out


def ring_shift(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """Every tensor sent to the next rank of the group's ring and the
    previous rank's received in its place (one batch of isend / irecv)."""
    n = dist.get_world_size(group)
    if n == 1:
        return list(tensors)
    me = dist.get_group_rank(group, dist.get_rank())
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    staged = _host_staged(tensors[0], group, "ring_shift")
    send = [_pinned(t) if staged else t.contiguous() for t in tensors]
    recv = [torch.empty_like(t) for t in send]
    ops = [dist.P2POp(dist.isend, t, nxt, group) for t in send] \
        + [dist.P2POp(dist.irecv, t, prv, group) for t in recv]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [r.to(t.device) for r, t in zip(recv, tensors)]
