"""Example: render one frame sharded over every rank of a process group.

n = the group's world size: a mesh of n_fb framebuffer bands x n_tri
triangle shards (n_tri = 2 when n is even).  Run alone it starts a
one-rank group itself (NCCL on the card, gloo with --device cpu); under
a launcher each rank renders its band:

    python -m softwarerenderer_tpu_torch.examples.multichip_render
        [--device cpu]
    torchrun --nproc-per-node 4 -m \\
        softwarerenderer_tpu_torch.examples.multichip_render

Every rank holds the whole frame; rank 0 writes it.
"""

import os
import socket

import numpy as np
import torch
import torch.distributed as dist
from PIL import Image

from softwarerenderer_tpu_torch import RenderParams
from softwarerenderer_tpu_torch.engine import default_frame_uniforms, to_rgb8
from softwarerenderer_tpu_torch.examples import cli, demo_device
from softwarerenderer_tpu_torch.models import primitives, scene
from softwarerenderer_tpu_torch.parallel import (
    make_mesh,
    multihost,
    render_frame_sharded,
    shard_scene_triangles,
)
from softwarerenderer_tpu_torch.utils import mathlib as ml

# Where rank 0 writes the frame (the JAX demo's path).
OUT = "/tmp/multichip.png"


def start_group(device) -> bool:
    """Join the process group a launcher describes (torchrun's RANK and
    WORLD_SIZE, or multihost's SRT_COORD), or start a one-rank group on
    a free localhost port.  Returns True when this call started one."""
    if dist.is_initialized():
        return False
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank = int(os.environ["RANK"])
        if device.type == "cuda":
            torch.cuda.set_device(multihost.local_rank(rank))
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
        return True
    if "SRT_COORD" in os.environ:
        return multihost.initialize_from_env(device=device.type)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    return True


def frame_inputs():
    """The demo's packed scene (a floor and ten cubes, numpy's seed 0),
    RenderParams and uniforms."""
    insts = [scene.MeshInstance(primitives.plane(20.0),
                                ml.translation([0.0, -1.0, 0.0]))]
    rng = np.random.default_rng(0)
    for _ in range(10):
        pos = rng.uniform(-5, 5, 3).astype(np.float32)
        pos[2] = rng.uniform(-8, -2)
        insts.append(scene.MeshInstance(primitives.cube(0.8),
                                        ml.translation(pos)))
    params = RenderParams(width=512, height=384, tile_h=16, tile_w=64,
                          tile_group=4)
    u = default_frame_uniforms(params.width, params.height)
    u["camera_position"] = np.float32([0.0, 1.0, 4.0])
    return scene.build_scene_buffers(insts), params, u


def main(device="cuda"):
    device = demo_device(device)
    started = start_group(device)
    try:
        n = dist.get_world_size()
        n_tri = 2 if n % 2 == 0 else 1
        n_fb = n // n_tri
        print(f"mesh: {n_fb} framebuffer bands x {n_tri} triangle shards")

        sc, params, u = frame_inputs()
        sc = shard_scene_triangles(sc, n_tri)
        mesh = make_mesh(n_fb, n_tri, device=device.type)
        color, depth = render_frame_sharded(sc, u, params, mesh)
        rgb = to_rgb8(color).cpu().numpy()
        if dist.get_rank() == 0:
            Image.fromarray(rgb).save(OUT)
            print(f"wrote {OUT}", rgb.shape)
        return rgb
    finally:
        if started:
            dist.destroy_process_group()


if __name__ == "__main__":
    cli(main)
