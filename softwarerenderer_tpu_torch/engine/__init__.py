"""Frame engine: the whole frame over device-resident scene tensors."""

from softwarerenderer_tpu_torch.engine.renderer import (  # noqa: F401
    Engine,
    camera_matrices,
    default_frame_uniforms,
    frame_setup,
    opaque_tri_flags,
    render_frame,
    render_frame_with_point_shadows,
    render_frame_with_shadows,
    render_frame_with_spot_shadow,
    scene_fragment_shader,
    scene_fragment_shader_bilinear,
    scene_fragment_shader_trilinear,
    scene_vertex_shader,
    to_rgb8,
)
