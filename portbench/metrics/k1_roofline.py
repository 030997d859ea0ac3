"""k1_roofline: K1's share of its roofline on the traced frames.

K1 (csrc/tile_raster.cu, span tile.fold) folds each tile's triangles
into a (depth, triangle) winner a pixel and resolves and interpolates the
winner's varyings into the G-buffer.  The least time the card could take
for that is counted from what the frame's inputs need, whatever the
kernel does (the plain reference's counts, portbench.reference.raster):

  operations = covered_pairs x TEST_OPS + covered_pixels x INTERP_OPS
  bytes      = valid_slots x SLOT_FLOATS x 4
               + width x height x k1_gbuffer_channels x 4

covered_pairs: the (slot, pixel) pairs whose pixel centre lies inside a
post-clip, LOD-selected slot; covered_pixels: the pixels some slot
covers; valid_slots: the slots set up.  TEST_OPS, the reference's float
operations for one pair: three edge values of 4 subtractions, 2
multiplications and 1 addition (21), and the depth: three edge values
times 1/area, three products with the corner depths, two additions (8);
29.  INTERP_OPS, for one winner: the edge values again (21), the three
weights times 1/area and over clip w (6), their sum and its reciprocal
(3); colour, uv and clip z, 7 channels of three products, two additions
and the normalising product (42); the world normal's three weights (3),
three channels of 5 (15), its renormalisation (3 products, 2 additions,
a root and 3 quotients: 9); 99.  SLOT_FLOATS: a slot's set-up row (3
screen corners, 3 depths, 1/area: 10) and its corners' payload (10
varying channels and clip w at 3 corners: 33), read once: 43.  The
G-buffer channels a pixel, written once, are the configuration's
(k1_gbuffer_channels).

bound = max(operations / 67 TFLOP/s, bytes / 3.35 TB/s), the H100's
float32 rate outside the tensor cores and its HBM rate; the share is
100 x bound / K1's kernel time in the trace, over the same frames.
"""

NAME, UNIT, LAYER, MOVES = "k1_roofline", "%", "K1", "frame_ms"
TEST_OPS = 29
INTERP_OPS = 99
SLOT_FLOATS = 43
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def bound_s(counts, size, channels):
    """The least seconds K1 could take over frames with these counts."""
    w, h = size
    ops = sum(c["covered_pairs"] * TEST_OPS + c["covered_pixels"] * INTERP_OPS
              for c in counts)
    nbytes = sum(c["valid_slots"] * SLOT_FLOATS * 4 + w * h * channels * 4
                 for c in counts)
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def read(summary, cell):
    k1_s = summary["kernel_ms_by_label"].get("K1", 0.0) * 1e-3 \
        * summary["frames"]
    if not k1_s or not summary.get("counts"):
        return None
    b = bound_s(summary["counts"], summary["k1_size"],
                summary["config"]["k1_gbuffer_channels"])
    return 100.0 * b / k1_s
