"""Tensor ops of the frame path; tile_raster holds the CUDA kernel."""
