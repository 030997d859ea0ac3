"""Tensor ops of the frame paths; tile_raster, vis_fold and rt_sweep wrap
the CUDA kernels."""
