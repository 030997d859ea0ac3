"""binning_gpu_ms: kernel ms a frame inside tile.bin_pack (ops/binning.py);
nothing when those spans held no kernel."""

NAME, UNIT, MOVES = "binning_gpu_ms", "ms", "frame_ms"
LAYER = "Binning"
SPANS = ("tile.bin_pack",)


def read(summary, cell):
    v = sum(summary["span_kernel_ms"].get(s, 0.0) for s in SPANS)
    return v or None
