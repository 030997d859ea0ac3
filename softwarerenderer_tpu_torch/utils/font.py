"""Host-side glyph-atlas builder for the device text overlay (ops/text.py).

The reference draws all of its text (chat, nametags, debug panel) through
ImGui's font atlas onto the GL surface (Renderer.cs:544-820); our host-side
analog is io_host/ui.py.  This module provides the DEVICE path's raw
material: a monospaced coverage atlas of the printable ASCII glyphs,
rasterized once on host (PIL's bundled default font) and shipped to the
device as a constant — so text composited by ops/text.py lives inside the
jitted frame program and survives headless captures, render-to-texture
passes and video recordings with zero host-side drawing.

Atlas layout: ``bitmaps`` is (96, cell_h, cell_w) float32 coverage in
[0, 1] for ASCII 32..127 (index = codepoint - 32; index 0 = space = all
zeros, index 95 = DEL = replacement box).  Monospace grid: every glyph is
drawn into the same fixed cell, advance = cell_w.
"""

from __future__ import annotations

import numpy as np

N_GLYPHS = 96
FIRST_CODEPOINT = 32


def _fallback_bitmaps(cell_h: int, cell_w: int) -> np.ndarray:
    """Environments without PIL still get a usable (if crude) atlas:
    a 1-px hollow box for every visible glyph, blank space/DEL."""
    out = np.zeros((N_GLYPHS, cell_h, cell_w), np.float32)
    box = np.zeros((cell_h, cell_w), np.float32)
    box[1:-1, 1] = box[1:-1, -2] = 1.0
    box[1, 1:-1] = box[-2, 1:-1] = 1.0
    for i in range(1, N_GLYPHS - 1):
        out[i] = box
    return out


def build_font(cell_h: int = 14) -> dict:
    """Rasterize the printable-ASCII glyph atlas.

    Returns {"bitmaps": (96, cell_h, cell_w) float32, "cell_h": int,
    "cell_w": int}.  cell_w is derived from the font's widest printable
    advance so the monospace grid never clips a glyph.
    """
    try:
        from PIL import Image, ImageDraw, ImageFont
    except ImportError:
        cw = max(2, cell_h * 5 // 8)
        return {"bitmaps": _fallback_bitmaps(cell_h, cw),
                "cell_h": cell_h, "cell_w": cw}
    try:
        fnt = ImageFont.load_default(size=int(cell_h * 0.82))
    except TypeError:                       # older PIL: bitmap-only default
        fnt = ImageFont.load_default()
    probe = ImageDraw.Draw(Image.new("L", (4, 4)))
    widths, descents = [], []
    for cp in range(FIRST_CODEPOINT, FIRST_CODEPOINT + N_GLYPHS - 1):
        x0, y0, x1, y1 = probe.textbbox((0, 0), chr(cp), font=fnt)
        widths.append(x1)
        descents.append(y1)
    cell_w = max(2, min(max(widths), cell_h))
    base = max(0, cell_h - max(descents) - 1)
    bitmaps = np.zeros((N_GLYPHS, cell_h, cell_w), np.float32)
    for i in range(1, N_GLYPHS - 1):        # skip space (0) and DEL (95)
        img = Image.new("L", (cell_w, cell_h), 0)
        ImageDraw.Draw(img).text((0, base), chr(FIRST_CODEPOINT + i),
                                 fill=255, font=fnt)
        bitmaps[i] = np.asarray(img, np.float32) / np.float32(255.0)
    # DEL (and every out-of-range codepoint ops/text maps here): a box.
    bitmaps[N_GLYPHS - 1] = _fallback_bitmaps(cell_h, cell_w)[1]
    return {"bitmaps": bitmaps, "cell_h": cell_h, "cell_w": cell_w}
