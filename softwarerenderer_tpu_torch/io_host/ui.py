"""HUD / debug overlay: crosshair, health, chat, nametags, tuning panel.

Role-equivalent of the reference's ImGui surface (Renderer.cs:289-820 —
crosshair :310-335, health bar :336-356, nametags :544-585, chat
:587-656, debug/tuning panel :658-820), drawn host-side onto the
presented window surface.  The overlay is a plain draw callback so any
window backend can host it; headless runs skip it entirely.

Nametag projection mirrors the reference exactly (Renderer.cs:549-573):
world point + 0.25 up → view·projection, behind-camera rejected (w ≤ 0),
NDC → window coords with Y flip.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np

from softwarerenderer_tpu_torch.utils import hostmath as ml


@dataclasses.dataclass
class HudState:
    health: float = 100.0
    fps: float = 0.0
    frame_ms: float = 0.0
    rendered_meshes: int = 0
    chat_messages: List[str] = dataclasses.field(default_factory=list)
    chat_input: str = ""
    chat_active: bool = False
    nametags: List[Tuple[float, float, str]] = \
        dataclasses.field(default_factory=list)
    debug_lines: List[str] = dataclasses.field(default_factory=list)
    show_debug: bool = False
    max_chat_lines: int = 8
    # Kill feed: (age-decayed) "attacker killed victim" entries, newest last
    kill_feed: List[Tuple[float, str]] = \
        dataclasses.field(default_factory=list)   # (expires_at, line)
    # Scoreboard overlay rows (name, kills, deaths, health); shown while
    # the scoreboard key (Tab) is held
    scoreboard: List[Tuple[str, int, int, float]] = \
        dataclasses.field(default_factory=list)
    show_scoreboard: bool = False
    # Spectator banner: name of the player being watched ("" = playing)
    spectating: str = ""
    # Clickable tunables panel rows (name, value, lo, hi) + selection —
    # filled by the app while show_debug; drawn as draggable sliders.
    tunables: List[Tuple[str, float, float, float]] = \
        dataclasses.field(default_factory=list)
    tune_selected: int = -1


def project_nametag(world_pos, view, projection, width: int, height: int
                    ) -> Optional[Tuple[float, float]]:
    """Renderer.RenderPlayerNametags' clip-space projection (:549-573)."""
    p = np.asarray(
        [world_pos[0], world_pos[1] + 0.25, world_pos[2], 1.0],
        dtype=np.float32)
    clip = ml.transform(ml.transform(p, view), projection)
    if clip[3] <= 0:
        return None
    ndc = clip[:3] / clip[3]
    x = (ndc[0] * 0.5 + 0.5) * width
    y = (1.0 - (ndc[1] * 0.5 + 0.5)) * height
    if not (0 <= x < width and 0 <= y < height):
        return None
    return float(x), float(y)


@dataclasses.dataclass
class HudLayout:
    """Persisted HUD layout/visibility (the analog of the reference's
    ImGui dock layout restored from OutputAssets/Layouts/DefaultLayout.ini
    — Renderer.cs:304-308).  Negative coordinates anchor
    from the right/bottom edge."""

    chat_pos: Tuple[int, int] = (16, 16)
    panel_pos: Tuple[int, int] = (16, 180)
    health_pos: Tuple[int, int] = (16, -40)
    killfeed_pos: Tuple[int, int] = (-12, 28)
    perf_pos: Tuple[int, int] = (-330, 8)
    show_crosshair: bool = True
    show_health: bool = True
    show_chat: bool = True
    show_killfeed: bool = True
    show_perf: bool = True
    show_debug: bool = False
    max_chat_lines: int = 8


def _anchor(pos, w: int, h: int) -> Tuple[int, int]:
    x, y = pos
    return (x if x >= 0 else w + x), (y if y >= 0 else h + y)


# --- clickable tunables panel geometry (r5) --------------------------------
# The reference's debug panel is a real ImGui surface with draggable
# sliders and a focusable chat input (Renderer.cs:658-820, 587-656).
# These PURE functions define the panel's screen geometry so the drawing
# code (Hud.__call__), the game's pointer handling (dust2._update_pointer)
# and the headless unit tests share one layout definition.

PANEL_PAD = 8
PANEL_ROW_H = 18
PANEL_LABEL_W = 160
PANEL_SLIDER_W = 140
PANEL_VALUE_W = 64
PANEL_HEADER_H = 22


def panel_size(n_rows: int) -> Tuple[int, int]:
    return (PANEL_PAD * 2 + PANEL_LABEL_W + PANEL_SLIDER_W
            + PANEL_VALUE_W,
            PANEL_HEADER_H + n_rows * PANEL_ROW_H + PANEL_PAD)


def panel_slider_rect(panel_pos, row: int) -> Tuple[int, int, int, int]:
    """(x, y, w, h) of row's slider TRACK (the clickable/draggable part)."""
    x, y = panel_pos
    return (x + PANEL_PAD + PANEL_LABEL_W,
            y + PANEL_HEADER_H + row * PANEL_ROW_H + 4,
            PANEL_SLIDER_W, PANEL_ROW_H - 8)


def point_in_rect(pos, rect) -> bool:
    x, y = pos
    rx, ry, rw, rh = rect
    return rx <= x < rx + rw and ry <= y < ry + rh


def panel_hit_row(panel_pos, n_rows: int, pos) -> Optional[int]:
    """Row whose slider track contains pos, else None.  Constant-time:
    derive the row from y, then bound-check against that row's rect."""
    x, y = pos
    row = (int(y) - panel_pos[1] - PANEL_HEADER_H) // PANEL_ROW_H
    if 0 <= row < n_rows:
        # widen vertically to the full row so drags between tracks hold
        rx, _, rw, _ = panel_slider_rect(panel_pos, row)
        if rx <= x < rx + rw:
            return row
    return None


def slider_value(panel_pos, row: int, x: float, lo: float,
                 hi: float) -> float:
    """Value for a drag at screen x on row's track (clamped to [lo, hi])."""
    rx, _, rw, _ = panel_slider_rect(panel_pos, row)
    frac = min(1.0, max(0.0, (x - rx) / max(1, rw - 1)))
    return lo + frac * (hi - lo)


def chat_input_rect(chat_pos, n_messages: int, max_lines: int,
                    w: int, h: int) -> Tuple[int, int, int, int]:
    """The chat input row's rect (click to focus — the reference's
    InputText, Renderer.cs:587-656): sits under the visible messages."""
    x, y = _anchor(chat_pos, w, h)
    return (x, y + 16 * min(n_messages, max_lines), 320, 18)


class Hud:
    def __init__(self):
        self.state = HudState()
        self.layout = HudLayout()
        self._font = None
        self._t_last = time.monotonic()

    def load_layout(self, path: str) -> bool:
        """Restore layout/visibility from a JSON file (unknown keys
        ignored, missing file → defaults).  Mirrors the reference's
        startup layout restore; returns True when a file was loaded."""
        import json
        import os
        if not os.path.isfile(path):
            return False
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            return False
        fields = {f.name for f in dataclasses.fields(HudLayout)}
        for k, v in data.items():
            if k in fields:
                cur = getattr(self.layout, k)
                setattr(self.layout, k,
                        tuple(v) if isinstance(cur, tuple) else v)
        self.state.show_debug = self.layout.show_debug
        self.state.max_chat_lines = self.layout.max_chat_lines
        return True

    def save_layout(self, path: str) -> None:
        """Persist the current layout + live visibility toggles."""
        import json
        self.layout.show_debug = self.state.show_debug
        self.layout.max_chat_lines = self.state.max_chat_lines
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self.layout), f, indent=1)

    def tick(self, dt: float) -> None:
        self.state.fps = 1.0 / dt if dt > 0 else 0.0
        self.state.frame_ms = dt * 1000.0

    def add_chat(self, line: str) -> None:
        self.state.chat_messages.append(line)
        del self.state.chat_messages[:-100]

    def add_kill(self, attacker: str, victim: str,
                 ttl: float = 6.0) -> None:
        """Kill-feed entry (top-right, expires after ttl seconds)."""
        self.state.kill_feed.append(
            (time.monotonic() + ttl, f"{attacker} \u2620 {victim}"))
        del self.state.kill_feed[:-6]

    def __call__(self, screen, pg) -> None:
        """Overlay callback for window.present."""
        s = self.state
        lay = self.layout
        if self._font is None:
            self._font = pg.font.SysFont("monospace", 14)
        w, h = screen.get_size()
        white = (255, 255, 255)

        # Crosshair (Renderer.cs:310-335): two centered lines.
        if lay.show_crosshair:
            cx, cy = w // 2, h // 2
            pg.draw.line(screen, white, (cx - 8, cy), (cx + 8, cy), 2)
            pg.draw.line(screen, white, (cx, cy - 8), (cx, cy + 8), 2)

        # Health bar (Renderer.cs:336-356).
        if lay.show_health:
            hx, hy = _anchor(lay.health_pos, w, h)
            frac = max(0.0, min(1.0, s.health / 100.0))
            bar_w = 180
            pg.draw.rect(screen, (40, 40, 40), (hx, hy, bar_w, 18))
            pg.draw.rect(screen, (200, 40, 40),
                         (hx, hy, int(bar_w * frac), 18))
            screen.blit(self._font.render(f"{s.health:.0f}", True, white),
                        (hx + bar_w + 8, hy))

        # Chat (Renderer.cs:587-656): last lines + input row.
        if lay.show_chat:
            chx, y = _anchor(lay.chat_pos, w, h)
            for line in s.chat_messages[-s.max_chat_lines:]:
                screen.blit(self._font.render(line[:80], True, white),
                            (chx, y))
                y += 16
            if s.chat_active:
                screen.blit(self._font.render("> " + s.chat_input, True,
                                              (255, 255, 0)), (chx, y))

        # Nametags (Renderer.cs:544-585).
        for x, ny, name in s.nametags:
            t = self._font.render(name, True, white)
            screen.blit(t, (int(x) - t.get_width() // 2, int(ny) - 18))

        # Kill feed (top-right, below perf) — expired entries drop out.
        now = time.monotonic()
        s.kill_feed[:] = [(t, line) for t, line in s.kill_feed if t > now]
        if lay.show_killfeed:
            kx, ky = _anchor(lay.killfeed_pos, w, h)
            for _, line in s.kill_feed:
                t = self._font.render(line, True, (255, 120, 120))
                screen.blit(t, (kx - t.get_width(), ky))
                ky += 16

        # Scoreboard overlay (hold Tab).
        if s.show_scoreboard and s.scoreboard:
            rows = [("player", "K", "D", "HP")] + [
                (n, str(k), str(d), f"{hp:.0f}")
                for n, k, d, hp in s.scoreboard]
            bw, rh = 320, 18
            bh = rh * (len(rows) + 1)
            bx, by = (w - bw) // 2, h // 4
            box = pg.Surface((bw, bh))
            box.set_alpha(200)
            box.fill((20, 20, 28))
            screen.blit(box, (bx, by))
            for i, (n, k, d, hp) in enumerate(rows):
                col = (255, 255, 160) if i == 0 else white
                yy = by + 8 + i * rh
                screen.blit(self._font.render(n[:22], True, col),
                            (bx + 10, yy))
                screen.blit(self._font.render(k, True, col), (bx + 210, yy))
                screen.blit(self._font.render(d, True, col), (bx + 250, yy))
                screen.blit(self._font.render(hp, True, col),
                            (bx + 282, yy))

        # Spectator banner (beyond-reference, like kill feed/scoreboard).
        if s.spectating:
            t = self._font.render(
                f"Spectating {s.spectating}   (B to cycle)", True,
                (160, 220, 255))
            screen.blit(t, ((w - t.get_width()) // 2, h - 70))

        # Performance + debug panel (Renderer.cs:662-668, 658-820).
        px_, py_ = _anchor(lay.perf_pos, w, h)
        if lay.show_perf:
            perf = f"{s.fps:5.1f} fps  {s.frame_ms:6.2f} ms  " \
                   f"meshes {s.rendered_meshes}"
            screen.blit(self._font.render(perf, True, (255, 255, 0)),
                        (px_, py_))
        if s.show_debug:
            y = py_ + 24
            for line in s.debug_lines:
                screen.blit(self._font.render(line, True, (0, 255, 128)),
                            (px_, y))
                y += 16

        # Clickable tunables panel: label + draggable slider + value per
        # row (geometry from the pure panel_* functions above, shared
        # with the game's pointer handling and the headless tests).
        if s.show_debug and s.tunables:
            ppx, ppy = _anchor(self.layout.panel_pos, w, h)
            pw_, ph_ = panel_size(len(s.tunables))
            box = pg.Surface((pw_, ph_))
            box.set_alpha(190)
            box.fill((16, 18, 26))
            screen.blit(box, (ppx, ppy))
            screen.blit(self._font.render(
                "tunables (drag sliders; [ ] -/= keys)", True,
                (255, 255, 160)), (ppx + PANEL_PAD, ppy + 4))
            for i, (name, val, lo, hi) in enumerate(s.tunables):
                ry = ppy + PANEL_HEADER_H + i * PANEL_ROW_H
                col = (255, 255, 160) if i == s.tune_selected else white
                screen.blit(self._font.render(name[:20], True, col),
                            (ppx + PANEL_PAD, ry))
                tx, ty, tw_, th_ = panel_slider_rect((ppx, ppy), i)
                pg.draw.rect(screen, (60, 60, 70), (tx, ty, tw_, th_))
                frac = 0.0 if hi <= lo else \
                    min(1.0, max(0.0, (val - lo) / (hi - lo)))
                pg.draw.rect(screen, (90, 170, 240),
                             (tx, ty, max(2, int(tw_ * frac)), th_))
                screen.blit(self._font.render(f"{val:.2f}", True, col),
                            (tx + tw_ + 8, ry))
