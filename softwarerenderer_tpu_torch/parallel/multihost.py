"""Multi-process bootstrap: one process a rank, started from environment
variables.

Counterpart of ``softwarerenderer_tpu/parallel/multihost.py``.  JAX's
multi-controller runtime runs one jitted program over every host's
devices; the port runs one process per rank instead (SPMD: every rank
calls the same frame function) on ``torch.distributed``, NCCL when each
rank has its own card and gloo on the CPU.  Each launch command starts one
rank:

  SRT_COORD=host0:29500 SRT_NUM_PROCS=4 SRT_PROC_ID=<i> python app.py

and the program calls ``initialize_from_env()`` before building a mesh.
Under ``torchrun`` the launcher's own variables do the same:
``dist.init_process_group("nccl")`` and then ``make_global_mesh``.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def local_rank(rank: int) -> int:
    """The card index of `rank` on its host: LOCAL_RANK when a launcher
    sets it, else the rank modulo the cards this host has (ranks beyond
    the cards share them)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return rank % max(1, torch.cuda.device_count())


def initialize_from_env(device: str = "cuda",
                        backend: Optional[str] = None) -> bool:
    """torch.distributed bootstrap from SRT_COORD (host:port of rank 0),
    SRT_NUM_PROCS and SRT_PROC_ID.  Returns True when running as one of
    several processes, False (and does nothing) when SRT_COORD is unset.

    device: "cuda" (the default) puts this rank on its card
    (local_rank) under NCCL; "cpu" runs it under gloo.  backend
    overrides the choice: "gloo" for several ranks on one card."""
    coord = os.environ.get("SRT_COORD")
    if not coord:
        return False
    world = int(os.environ["SRT_NUM_PROCS"])
    rank = int(os.environ["SRT_PROC_ID"])
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_from_env(device='cuda') needs a "
                               "CUDA device and none is available")
        torch.cuda.set_device(local_rank(rank))
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=f"tcp://{coord}", world_size=world, rank=rank)
    return True


def make_global_mesh(n_fb: Optional[int] = None, n_tri: int = 1,
                     device: Optional[str] = None):
    """An (fb, tri) mesh over every rank of the process group, n_fb =
    world // n_tri by default.  Ranks fill it row-major, as JAX's
    processes fill its devices: consecutive ranks (one host's cards) hold
    one band's triangle shards, so the "tri" reduce stays among them and
    only the "fb" gather crosses hosts."""
    from softwarerenderer_tpu_torch.parallel.sharding import make_mesh
    if n_fb is None:
        n_fb = dist.get_world_size() // n_tri
    return make_mesh(n_fb, n_tri, device=device)
