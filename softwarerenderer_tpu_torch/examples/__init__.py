"""The JAX package's 19 demos (``examples/*.py``) on the port, one module
each with the same basename.  Each builds the same scene, camera,
RenderParams, uniforms and number of frames as its JAX demo and writes the
same files to the same default paths; ``main`` keeps the JAX demo's
signature, adds ``device="cuda"`` (no card raises, it never renders on the
CPU instead) and returns what it wrote: the RGB8 image, or the list of
them in the order written (``showcase`` returns its AVI's path).

    python -m softwarerenderer_tpu_torch.examples.<name> [args] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import torch

# The demos, in the order they were ported.
DEMOS = ("spinning_cube", "custom_shader", "translucency_kbuffer",
         "raytraced", "shadowed_scene", "point_light_shadows",
         "pbr_materials", "sky_environment", "normal_mapping", "mesh_lod",
         "morph_targets", "skeletal_animation", "skinned_crowd",
         "particle_fountain", "ai_agents", "render_to_texture",
         "split_screen", "multichip_render", "showcase")


def demo_device(device) -> torch.device:
    """`device` as a torch.device: asking for CUDA where there is none
    raises, a demo never renders on the CPU instead."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} needs a CUDA device and none "
                           "is available (pass device='cpu')")
    return dev


def cli(main, *types, argv=None):
    """Run a demo's main from the command line: up to len(types)
    positional arguments, each converted by its type, and --device."""
    ap = argparse.ArgumentParser(prog=getattr(main, "__module__", None))
    ap.add_argument("args", nargs="*")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default cuda)")
    a = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if len(a.args) > len(types):
        ap.error(f"at most {len(types)} positional arguments")
    main(*(t(v) for t, v in zip(types, a.args)), device=a.device)
