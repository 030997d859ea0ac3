"""Tensor ops of the frame paths; tile_raster, vis_fold and rt_sweep wrap
the CUDA kernels."""
from softwarerenderer_tpu_torch.ops import texture  # noqa: F401
