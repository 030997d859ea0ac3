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
the ``shaders`` ABI: the opaque route, with ``RenderParams(kbuffer=K)`` the
depth-peeled K-buffer (LESS_EQUAL depth), and with
``frame_fn=ops.raytrace.render_frame_raytraced`` the ray-traced frame;
every option outside them raises ``NotImplementedError``.
"""

from softwarerenderer_tpu_torch.config import (  # noqa: F401
    BlendMode,
    CullMode,
    DebugMode,
    DepthTest,
    RenderParams,
)
