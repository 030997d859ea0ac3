"""Text burned into the frame on the device: packed glyph strings
composited over the framebuffer.

Counterpart of ``softwarerenderer_tpu/ops/text.py``.  Strings are packed on
the host (``pack_text``) into small fixed-shape arrays that ride the
uniforms, so content and position are data, and ``composite_text`` blends
them over the frame with device ops only: the glyphs of each string slot
are gathered into one (cell_h, max_chars * cell_w) coverage strip, and
each slot is one gather, lerp and indexed write at its position.  The
composite runs on a copy of the frame padded by a strip on every side and
cropped back, with positions clipped into the pad as the JAX function
clips them, so a string may hang off any edge or sit wholly off screen
(it vanishes; it is never dragged back into view).  Slots with alpha 0 and
pixels a glyph does not cover keep their values bit for bit.

``text_overlay_fx`` makes it a callable post-FX stage
(RenderParams.post_fx): the game's ``--burn-hud``.  ``encode_glyphs``,
``pack_text`` and ``text_size`` are the JAX module's numpy functions.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from softwarerenderer_tpu_torch.utils.font import FIRST_CODEPOINT, N_GLYPHS

F32 = np.float32


def encode_glyphs(text: str, max_chars: int) -> np.ndarray:
    """ASCII string -> (max_chars,) int32 atlas indices (space-padded).

    Printable ASCII maps to codepoint - 32; control characters map to
    space; anything >= DEL maps to the replacement box (index 95)."""
    ids = np.zeros((max_chars,), np.int32)
    for j, ch in enumerate(text[:max_chars]):
        cp = ord(ch)
        if cp < FIRST_CODEPOINT:
            ids[j] = 0
        elif cp >= FIRST_CODEPOINT + N_GLYPHS - 1:
            ids[j] = N_GLYPHS - 1
        else:
            ids[j] = cp - FIRST_CODEPOINT
    return ids


def pack_text(entries: Sequence, max_strings: int = 8,
              max_chars: int = 48) -> dict:
    """Pack up to `max_strings` text entries into the fixed-shape arrays
    composite_text takes.

    entries: (text, (x, y)) or (text, (x, y), (r, g, b[, a])) tuples,
    (x, y) the string's top left in pixels, white by default.  Unused
    slots get alpha 0; entries past max_strings and characters past
    max_chars are dropped from the tail.

    Returns {"glyphs": (S, L) i32, "pos": (S, 2) i32, "color": (S, 4) f32}.
    """
    S, L = int(max_strings), int(max_chars)
    glyphs = np.zeros((S, L), np.int32)
    pos = np.zeros((S, 2), np.int32)
    color = np.zeros((S, 4), F32)
    for i, e in enumerate(entries[:S]):
        text, xy = e[0], e[1]
        c = tuple(e[2]) if len(e) > 2 else (1.0, 1.0, 1.0, 1.0)
        if len(c) == 3:
            c = c + (1.0,)
        glyphs[i] = encode_glyphs(str(text), L)
        pos[i] = (int(xy[0]), int(xy[1]))
        color[i] = c
    return {"glyphs": glyphs, "pos": pos, "color": color}


def text_size(font: dict, text: str) -> Tuple[int, int]:
    """(width, height) in pixels of `text` on the monospace grid."""
    return len(text) * int(font["cell_w"]), int(font["cell_h"])


def composite_text(color: torch.Tensor, bitmaps: torch.Tensor,
                   packed: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Blend packed text over a (H, W, C) colour buffer; returns a new
    buffer.  bitmaps: the font atlas (96, gh, gw) f32 on color's device;
    packed: pack_text's arrays (tensors on that device, or host arrays,
    which are copied there).

    Per slot, in order: every covered channel lerps toward (r, g, b, 1)
    by coverage x alpha; uncovered pixels and alpha-0 slots are left as
    they are (a where, not a blend by 0).  No host read."""
    dev = color.device
    glyphs, pos, scol = (torch.as_tensor(packed[k], dtype=t, device=dev)
                         for k, t in (("glyphs", torch.int32),
                                      ("pos", torch.int32),
                                      ("color", torch.float32)))
    S, L = glyphs.shape
    gh, gw = bitmaps.shape[1], bitmaps.shape[2]
    H, W, C = color.shape
    sw, sh = L * gw, gh
    # (S, L, gh, gw) coverage -> (S, gh, L * gw) strips.
    strips = bitmaps[glyphs.reshape(-1).long()].reshape(S, L, gh, gw) \
        .permute(0, 2, 1, 3).reshape(S, gh, sw)
    padded = torch.nn.functional.pad(color, (0, 0, sw, sw, sh, sh))
    # Positions in padded coordinates, clipped as the JAX function clips
    # them: a moved string stays inside the pad margin and is cropped.
    x = (pos[:, 0] + sw).clamp(0, W + sw).long()
    y = (pos[:, 1] + sh).clamp(0, H + sh).long()
    tgt = torch.cat([scol[:, :3], torch.ones_like(scol[:, :1])], 1)[:, :C]
    rows = (y[:, None] + torch.arange(sh, device=dev))[:, :, None]
    cols = (x[:, None] + torch.arange(sw, device=dev))[:, None, :]
    alpha = (strips * scol[:, 3, None, None])[..., None]    # (S, sh, sw, 1)
    for i in range(S):
        patch = padded[rows[i], cols[i]]                      # (sh, sw, C)
        a = alpha[i]
        blended = patch + (tgt[i] - patch) * a
        padded.index_put_((rows[i], cols[i]),
                          torch.where(a > 0, blended, patch))
    return padded[sh:sh + H, sw:sw + W]


def text_overlay_fx(font: dict, uniforms_key: str = "hud_text"):
    """A callable post-FX stage (RenderParams.post_fx) that composites the
    packed text in uniforms[uniforms_key] over the finished frame; a frame
    whose uniforms lack the key is returned as it is.  The font atlas goes
    to each device once and is kept."""
    bitmaps = np.asarray(font["bitmaps"], F32)
    on_device: Dict[torch.device, torch.Tensor] = {}

    def fx(color, depth, uniforms):
        packed = uniforms.get(uniforms_key)
        if packed is None:
            return color, depth
        bm = on_device.get(color.device)
        if bm is None:
            bm = on_device[color.device] = torch.from_numpy(bitmaps).to(
                color.device)
        return composite_text(color, bm, packed), depth

    return fx
