"""post_gpu_ms: kernel ms a frame inside the post chain's stages
(post.sky, post.ssao, post.bloom, post.tonemap, post.fxaa) and the ssaa
box resolve (frame.ssaa_resolve), engine/renderer.py's post_chained and
supersampled; nothing when those spans held no kernel."""

NAME, UNIT, MOVES = "post_gpu_ms", "ms", "frame_ms"
LAYER = "Post chain"
SPANS = ("post.sky", "post.ssao", "post.bloom", "post.tonemap",
         "post.fxaa", "frame.ssaa_resolve")


def read(summary, cell):
    v = sum(summary["span_kernel_ms"].get(s, 0.0) for s in SPANS)
    return v or None
