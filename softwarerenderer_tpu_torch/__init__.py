"""softwarerenderer_tpu_torch — the renderer in PyTorch, with CUDA kernels.

A port of ``softwarerenderer_tpu`` (JAX, Pallas kernels for the TPU) to
PyTorch on an NVIDIA H100: plain tensor code is PyTorch, and each Pallas
kernel becomes a kernel written by hand for Hopper under ``csrc/``, built at
first use by ``kernels/build.py``.  File names mirror the JAX package's, so
each module's counterpart is found by its path.  The JAX package's
numpy-only host layer (``config``, ``models.scene``, ``models.primitives``)
is shared, not copied; nothing here imports JAX.

What renders today is the frame of ``engine.Engine`` with any shaders of
the ``shaders`` ABI: the opaque route and, with ``RenderParams(kbuffer=K)``,
the depth-peeled K-buffer (LESS_EQUAL depth); every option outside them
raises ``NotImplementedError``.
"""

from softwarerenderer_tpu.config import (  # noqa: F401
    BlendMode,
    CullMode,
    DebugMode,
    DepthTest,
    RenderParams,
)
