"""Pipeline state enums and render parameters.

Copied from softwarerenderer_tpu/config.py so that the port imports
nothing of the JAX package; keep the two equal (tests/test_torch_package.py
holds the field names, defaults and enum values to the source).  The enums
are IntEnums, so values compare equal across the two packages; the port
reads RenderParams fields and never checks its class, so callers may pass
either package's.  The TPU-only fields (tile_group, chunk,
pallas_interpret, ...) are kept and ignored by the port.  use_pallas=False
selects the deferred route (ops.raster.render_deferred, whose visibility
pass is the visibility-fold kernel) for a binned LESS_EQUAL frame, as it
selects the non-Pallas route in JAX; a K-buffer frame keeps its tile
routes either way.

Mirrors the reference pipeline's state vocabulary (Rasterizer.cs:25-50 of
the C# reference: BlendMode/DepthTest/CullMode enums, NearClip/FarClip
statics, DebugMode) as plain IntEnums so they can be used as *static*
arguments to jitted programs (switching depth test / blend mode recompiles,
which is the XLA-native analog of the reference's per-draw function pointer
selection at Rasterizer.cs:542-559).

Semantics notes (faithful to the reference, see SURVEY.md §6):
  * Depth buffer clears to -inf (MainWindow.cs:434) and pixel depth is
    (ndcZ+1)/2 (Rasterizer.cs:388).
  * The depth-test table is the reference's *as implemented*
    (Rasterizer.cs:542-559): LESS_EQUAL means "new >= old", LESS means
    "new > old", GREATER means "new < old", GREATER_EQUAL means
    "new <= old", EQUAL/NOT_EQUAL use |new-old| vs 1e-6.
  * The reference's barycentric weights sum to -1 (its EdgeFunction sign
    convention vs its a/b edge deltas, Rasterizer.cs:445-447,481-483 —
    verified numerically), so the *interpolated* depth written to the
    buffer is the NEGATED combination of the per-vertex (ndcZ+1)/2 values:
    stored depth runs -0.5 at the near plane to -1.0 at far, monotonically
    decreasing with distance.  The inverted ">=" comparison therefore
    yields conventional nearest-wins z-buffering — two accidental
    negations that cancel.  Parity requires replicating both.
"""

from __future__ import annotations

import dataclasses
import enum


class DepthTest(enum.IntEnum):
    """Depth-test modes; comparison semantics per Rasterizer.cs:542-559."""

    DISABLED = 0
    LESS = 1          # passes when new > old   (reference's inverted table)
    LESS_EQUAL = 2    # passes when new >= old  (reference default)
    GREATER = 3       # passes when new < old   (conventional nearest-wins)
    GREATER_EQUAL = 4 # passes when new <= old
    EQUAL = 5         # |new - old| <  1e-6
    NOT_EQUAL = 6     # |new - old| >= 1e-6
    ALWAYS = 7


class BlendMode(enum.IntEnum):
    """Framebuffer blend modes (Rasterizer.cs:57-65)."""

    NONE = 0      # src
    ALPHA = 1     # src*src.a + dst*(1-src.a)   (note: alpha channel blends too)
    ADDITIVE = 2  # min(src+dst, 1)
    MULTIPLY = 3  # src*dst


class CullMode(enum.IntEnum):
    """Face culling (Rasterizer.cs:45-50); front face = signed area < 0
    after the raster-order vertex reversal (Rasterizer.cs:367,414)."""

    NONE = 0
    BACK = 1
    FRONT = 2


class DebugMode(enum.IntEnum):
    """Raster debug modes.  NONE/WIREFRAME mirror the reference
    (Rasterizer.cs:14-18); OVERDRAW (per-pixel coverage heatmap) and
    DEPTH (normalized depth-buffer view) are beyond-reference debug
    tools (ops/debugviz.py)."""

    NONE = 0
    WIREFRAME = 1
    OVERDRAW = 2
    DEPTH = 3


# Epsilon used by EQUAL/NOT_EQUAL depth tests and by the clipper's
# degenerate-denominator fallback (Rasterizer.cs:52).
EPSILON = 1e-6


@dataclasses.dataclass(frozen=True)
class RenderParams:
    """Static (compile-time) rasterizer configuration.

    Everything here changes program structure, so it is hashable and passed
    as a static argument to jit.  Per-frame *traced* values (matrices, fog,
    light, clear color, near/far clip scalars) travel in `engine.frame`
    uniforms instead, so live-tuning them does not recompile — the analog of
    the reference's ImGui sliders (Renderer.cs:690-817).
    """

    width: int = 800
    height: int = 600
    depth_test: DepthTest = DepthTest.LESS_EQUAL
    blend_mode: BlendMode = BlendMode.ALPHA
    cull_mode: CullMode = CullMode.BACK
    debug_mode: DebugMode = DebugMode.NONE
    # Deferred (visibility-buffer) vs forward (sequential, blend-exact) path.
    deferred: bool = True
    # Visibility strategy: tile-binned (work ∝ triangle-tile overlap) vs
    # brute force (every triangle × every pixel; the correctness slice).
    binned: bool = True
    # Tile/chunk defaults from the round-2 sweep on TPU v5e @1080p dust2
    # (BENCHMARKS.md): 32x128 tiles, 16-tile groups, 32-triangle chunks,
    # span_cap 8 (smaller pair table; the Pallas kernel keeps globals
    # resident in VMEM so the bigger global list is free).
    tile_h: int = 32          # screen tile size for binning
    tile_w: int = 128         # last dim 128 = TPU lane width
    span_cap: int = 8         # bbox tile-span above which a tri goes global
    tile_group: int = 16      # tiles processed per sequential step
    chunk: int = 32           # triangles folded per reduction step
    # Active-triangle compaction (ops/geometry.compact_triangles): stable-
    # partition valid triangle slots into this many before binning, so
    # pair-sort + stream-gather cost scales with ACTIVE triangles instead
    # of packed slots.  Essential for scenes packing alternative geometry
    # (mesh-LOD levels, hidden meshes).  Exact whenever the frame's valid
    # slots fit (ops/lod.suggested_active_cap gives a bound that always
    # does); overflow drops the last-submitted triangles.  0 = off.
    active_cap: int = 0
    # Pre-geometry compaction (engine.render_frame): stable-partition the
    # INPUT triangles selected by the frame's visibility+LOD mask into
    # this many slots BEFORE vertex assembly/clip/setup, so the whole
    # geometry build scales with ACTIVE triangles instead of packed input
    # slots (every LOD level, hidden meshes).  The mask is known before
    # geometry runs, so this removes the build-stage cost active_cap
    # cannot touch (measured ~34 ms of the 4K LOD-crowd frame at 1.17M
    # fan slots, scripts/profile_build_stages.py).  Exact whenever the
    # frame's masked-in triangles fit (ops/lod.suggested_geom_cap gives a
    # bound that always does); overflow drops the last-submitted
    # triangles deterministically — guard tight caps with
    # active_cap_stats' "geom_cap_overflow" counter.  Composes with
    # active_cap (which then compacts the much smaller post-cull set).
    # 0 = off.
    geom_cap: int = 0
    # Capacity counters: ALSO return a stats dict with "live_pairs" (the
    # frame's live (tile, triangle) pair count — measure a workload with
    # this before choosing pair_cap), "live_globals" (the frame's
    # global-triangle count — measure before choosing global_cap),
    # "active_cap_overflow" (with active_cap: valid slots the cap
    # dropped; 0 = exact), "pair_cap_overflow" (with pair_cap: live
    # pairs dropped; 0 = exact) and "global_cap_overflow" (with
    # global_cap: globals dropped; 0 = exact).  Changes render_frame's
    # return to (color, depth, stats);
    # incompatible with ssaa/post-fx recursion (ValueError); merges into
    # the kbuffer_stats dict when both are set.
    active_cap_stats: bool = False
    # Pair-table truncation (ops/binning.bin_triangles): stable-compact
    # the LIVE (tile, triangle) pairs to this static prefix BEFORE the
    # pair sort, so the sort and the Pallas stream gathers scale with
    # actual triangle-tile overlap instead of the padded N·span_cap
    # table (which dominates large compacted scenes: the pair table is
    # ~90% sentinel tail at profile_lod's tight active_cap).  Exact
    # whenever the frame's live pairs fit; overflow drops the
    # last-submitted pairs deterministically — guard tight caps with
    # active_cap_stats' "pair_cap_overflow" counter.  0 = off (full
    # N·span_cap table).
    pair_cap: int = 0
    # Global-stream truncation (ops/pallas_tile): keep only the first
    # `global_cap` entries of the binning order stream — the global
    # (span > span_cap) triangles lead it in submission order, so the
    # stream's setup/payload gathers scale with this cap instead of the
    # full slot count.  Exact whenever the frame's global-triangle count
    # fits (typical scenes have tens: dust2 @1080p has 49); overflow
    # drops the last-submitted globals — guard with active_cap_stats'
    # "global_cap_overflow" counter.  Rounded up to the kernel's
    # VMEM-resident minimum (256).  0 = off (full-slot stream).
    global_cap: int = 0
    # Lazy attr compaction (ops/geometry.compact_triangles lazy_attrs):
    # with active_cap on the Pallas route, leave the wide per-triangle
    # attr payload UN-gathered at full slot count and fold the
    # compaction permutation into the stream gathers instead — payload
    # gather cost then scales with live pairs (pair_cap) + global_cap,
    # not with active_cap × payload width.  Bit-exact (the composed
    # gather reproduces the eager rows); False forces the eager gather
    # everywhere (debug / A-B).
    lazy_compaction: bool = True
    # Mip-mapped texture sampling (beyond the reference):
    # per-triangle LOD from the uv-area/screen-area ratio selects a
    # box-filtered mip from the atlas chain.  False = off (mip 0, the
    # exact parity mode — the reference has no mips); True = nearest mip;
    # "trilinear" = two bracketing mips blended in the fragment stage
    # (pair with engine.scene_fragment_shader_trilinear).
    use_mipmaps: object = False    # False | True | "trilinear"
    # K-buffer depth (ops/kbuffer): keep the K best fragments per pixel
    # and replay the reference's sequential shade/blend over them in
    # submission order — order-correct translucency and discard-reveal at
    # binned cost (exact while each pixel's contributing fragments fit in
    # K).  0/1 = winner-only deferred shading (the opaque fast path).
    kbuffer: int = 0
    # With kbuffer > 1: ALSO return a stats dict {"kbuffer_saturated_px"}
    # — the runtime K-overflow indicator (pixels whose K-th layer holds a
    # fragment; exactness may have degraded only among those).  Changes
    # render_frame's return to (color, depth, stats); incompatible with
    # ssaa/post-fx recursion (ValueError).
    kbuffer_stats: bool = False
    # Opaque short-circuit for the depth-peeled Pallas K-buffer: stop
    # peeling at pixels whose winner is semantically opaque (pack-time
    # per-triangle flags, engine.opaque_tri_flags) AND visibly shaded
    # (alpha > 0) — under ALPHA/NONE blending a worse-ranked fragment
    # can never be visible there — and lax.cond-skip passes with no
    # eligible pixels anywhere.  Exact to one blend ulp (≤ ~1.2e-7 per
    # channel where interpolated alpha rounds below 1; bit-identical
    # elsewhere — PARITY.md "Exactness-preserving optimizations").
    # False for measuring natural peel coverage
    # (scripts/measure_kbuffer_coverage.py) or forcing strict
    # bit-identity to the XLA K-slot fold.
    kbuffer_short_circuit: bool = True
    # Row-compacted layer shading for peel passes k >= 1 (the Pallas
    # K-buffer): when the pass's live pixels span at most this fraction
    # of the framebuffer's ROWS, gather those rows, shade the compacted
    # (rows, W) block, and scatter back — sparse translucency then pays
    # shading for its own rows instead of the full frame.  Row (not
    # pixel) granularity because TPU row gathers are bandwidth-priced
    # while per-pixel gathers charge per element (BENCHMARKS.md gather
    # model).  Bit-exact: the shader ABI is per-pixel, and pixels whose
    # winner map says "none" are never read by the replay.  0 disables.
    kbuffer_compact_rows: float = 0.5
    # APPROXIMATE opt-in mode (r5, VERDICT r4 #10): shade every
    # shade_rate-th ROW over the full-resolution winner maps and
    # replicate the shaded color down each row block — the kernel's
    # visibility fold runs at full res (anchor rows stay identical to
    # full-rate in depth, and in color to 1 ulp of cross-compilation
    # fusion), while non-anchor rows follow their anchor's shaded
    # write/discard decision (a thin silhouette band may differ);
    # shading cost (texel gathers + shader math) drops ~shade_rate×.
    # Rows, not 2x2 blocks: column-strided subsampling crosses TPU
    # lanes and costs more than it saves (measured — BENCHMARKS.md).
    # NOT a parity mode: it has its own golden contract
    # (tests/test_pallas_raster.py shade-rate case) and never engages
    # unless explicitly set.  Pallas opaque route only (kbuffer > 1 or
    # other routes raise); the frame height must divide by shade_rate.
    shade_rate: int = 1
    # Run fold+resolve+interp as one Pallas tile kernel (ops/pallas_tile)
    # with shading as a single full-frame pass — the fastest path, default
    # ON.  Engages only on the TPU backend with LESS_EQUAL depth; every
    # other configuration falls back to the XLA fused path automatically.
    use_pallas: bool = True
    # Run the Pallas routes in interpret mode on any backend (tests /
    # debugging: the kernel code path without Mosaic hardware).  The
    # interpret compilation can differ from the XLA fused path by an FMA
    # ulp on borderline edge pixels — compare interpret against
    # interpret, not against fused, for exact asserts.
    pallas_interpret: bool = False
    # Screen-space ambient occlusion (ops/ssao.py, beyond the reference):
    # a depth-only crease-darkening post pass in the same program.  Off
    # by default (the parity mode).
    ssao: bool = False
    # Bloom post pass (ops/bloom.py, beyond the reference): bright-pass +
    # shift-based separable blur, additive.  Off by default.
    bloom: bool = False
    # Tone mapping (ops/tonemap.py): None (raw clip, the parity mode) |
    # "reinhard" | "aces".  Runs outermost, after bloom; exposure is the
    # traced uniforms["exposure"].
    tonemap: object = None
    # Supersampled anti-aliasing (beyond the reference, which has none):
    # render every pass at ssaa× in each axis, then box-filter colors back
    # to (height, width).  Returned depth is the supersample-grid's
    # top-left sample per output pixel (a real rendered sample, not an
    # average of unrelated depths).  1 = off (the parity mode).
    ssaa: int = 1
    # FXAA-style post-process AA (ops/fxaa.py, beyond the reference):
    # gather-free subpixel anti-aliasing — edge-detected blend toward the
    # perpendicular neighbor average, a few fused elementwise ops per
    # pixel (vs ssaa's exact but ssaa²× render cost).  Composes with
    # ssaa.  Off by default (the parity mode).
    fxaa: bool = False
    # Post-FX pipeline AS DATA: the order effects apply to the finished
    # (color, depth) frame.  Each entry runs only when its own switch is
    # on (sky: uniforms["sky_panorama"] present; ssao/bloom: the flags
    # above; tonemap: the mode above), so this tuple is pure ordering.
    # The default reproduces the round-2 fixed nesting exactly (goldens
    # stable); reordering is a real visual choice — e.g. bloom AFTER
    # tonemap glows from display-referred values and clips differently
    # than the default scene-referred bloom.  Entries may also be USER
    # CALLABLES `fx(color, depth, uniforms) -> (color, depth)` (or just
    # a color return) — traced into the same jitted frame at their slot
    # in the order, the post-pipeline analog of the user vertex/fragment
    # shader ABI.  Callables are always on; they compose with sharding
    # (each shard applies the full-frame chain after the gather).
    post_fx: tuple = ("sky", "ssao", "bloom", "tonemap", "fxaa")

    def replace(self, **kw) -> "RenderParams":
        return dataclasses.replace(self, **kw)
