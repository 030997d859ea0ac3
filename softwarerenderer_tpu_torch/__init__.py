"""softwarerenderer_tpu_torch — the renderer in PyTorch, with CUDA kernels.

A port of ``softwarerenderer_tpu`` (JAX, Pallas kernels for the TPU) to
PyTorch on an NVIDIA H100: plain tensor code is PyTorch, and each Pallas
kernel becomes a kernel written by hand for Hopper under ``csrc/``, built at
first use by ``kernels/build.py``.  File names mirror the JAX package's, so
each module's counterpart is found by its path.  The port keeps its own
copy of the numpy host layer it needs (``config``, ``models.scene``,
``models.primitives``, the texture and matrix constructors, and the
checked scenes in ``scenes``); nothing here imports JAX or any module of
the JAX package.

What renders today is the frame of ``engine.Engine`` with any shaders of
the ``shaders`` ABI: the opaque tile route, the deferred route
(``RenderParams(use_pallas=False)``, every monotone depth test,
``binned=False``), the exact forward route (``deferred=False``, EQUAL and
NOT_EQUAL), the wireframe, overdraw and depth views, with
``RenderParams(kbuffer=K)`` the K-buffer, with
``frame_fn=ops.raytrace.render_frame_raytraced`` the ray-traced frame,
with ``ops.lighting``'s shaders multi-light and PBR frames, and through
``engine.render_frame_with_shadows`` / ``_with_point_shadows`` /
``_with_spot_shadow`` frames with shadow maps, with the capacity caps and
shade_rate, and through ``engine.render_frame_multiview``,
``render_frame_pip`` and ``engine.rtt`` split screens, insets and
render-to-texture passes; ``ops.text`` burns text into a frame and
``utils.video`` records frames.  The simulation steps on the same device
(``sim``: the character controller, the AI crowd and the particle system,
drawing JAX's own threefry streams through ``sim.prng``); ``scenes``
holds bench.py config 4's coupled step and a crowd on the bench scene,
and ``utils.checkpoint`` saves and restores their states.  ``apps.dust2``
is the Dust2 game on all of it (one ``fused_step`` a frame, a pipelined
present, the JAX app's host loop, its mirror, burned-in HUD and
recording), with the host layer it needs copied
from the JAX package under ``io_host`` (window, HUD, audio, networking,
the model loaders).  ``apps.viewer`` is the model viewer (orbit, the
debug views, the ray-traced mode, GLB export), over the glTF, OBJ, STL,
PLY, COLLADA, FBX and 3DS loaders and ``native``, the C++ asset library
the loaders bake transforms with (numpy forms of equal value without a
compiler).
"""

from softwarerenderer_tpu_torch.config import (  # noqa: F401
    BlendMode,
    CullMode,
    DebugMode,
    DepthTest,
    RenderParams,
)
