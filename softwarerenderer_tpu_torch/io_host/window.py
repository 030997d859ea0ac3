"""Window/present + input: blit device-rendered frames to a window.

Role-equivalent of MainWindow.cs (GLFW window + GL textured fullscreen
quad + input contexts, MainWindow.cs:45-266): owns the
window, presents RGB frames, exposes keyboard/mouse state, and implements
the render-scale decoupling (render resolution = window × scale,
MainWindow.cs:93-96, 268-274) and the 0.25 s debounced resize
(MainWindow.cs:278-296).

Backends:
  * PygameWindow — SDL window; the framebuffer upload is one surfarray
    blit + scale (the analog of the reference's TexSubImage2D + quad).
  * HeadlessWindow — no display; optionally writes frames as PNGs.
    Keeps the full API so the game loop is backend-agnostic.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Tuple

import numpy as np


class WindowBase:
    def __init__(self, width: int, height: int, render_scale: float = 0.25):
        self.width = width
        self.height = height
        self.render_scale = max(0.1, min(1.0, render_scale))
        self.should_close = False
        self.mouse_captured = False
        self._pending_resize: Optional[Tuple[int, int, float]] = None

    @property
    def render_size(self) -> Tuple[int, int]:
        """Render resolution = window × scale (MainWindow.cs:93-96),
        min 1 px."""
        return (max(1, int(self.width * self.render_scale)),
                max(1, int(self.height * self.render_scale)))

    def poll(self) -> dict:
        """Returns {"keys": set[str], "mouse_delta": (dx, dy),
        "mouse_down": bool, "mouse_held": bool, "mouse_pos": (x, y),
        "chars": str, "quit": bool,
        "gamepad": {"move": (x, y), "look": (x, y), "jump": bool,
        "fire": bool} | None}.

        mouse_pos/mouse_held drive the clickable HUD (tunables sliders,
        chat focus) while the cursor is released (Esc); consumers use
        .get() so hand-built input dicts may omit them.

        Gamepad convention (beyond the reference, which reads keyboard +
        mouse only, Renderer.cs:140-161, 358-383): move/look are
        deadzone-filtered stick values in [-1, 1] (+x right, +y forward /
        look-down-positive like mouse dy), jump = south button,
        fire = right trigger/bumper."""
        raise NotImplementedError

    def present(self, rgb: np.ndarray, overlay=None) -> None:
        raise NotImplementedError

    def set_mouse_capture(self, captured: bool) -> None:
        self.mouse_captured = captured

    def close(self) -> None:
        pass


class HeadlessWindow(WindowBase):
    """Null present backend: optional PNG dump per frame."""

    def __init__(self, width: int, height: int, render_scale: float = 0.25,
                 out_path: Optional[str] = None):
        super().__init__(width, height, render_scale)
        self.out_path = out_path
        self.frame_index = 0
        self.last_frame: Optional[np.ndarray] = None

    def poll(self) -> dict:
        return {"keys": set(), "mouse_delta": (0.0, 0.0),
                "mouse_down": False, "mouse_held": False,
                "mouse_pos": (0, 0), "chars": "", "quit": False,
                "gamepad": None}

    def present(self, rgb: np.ndarray, overlay=None) -> None:
        self.last_frame = np.asarray(rgb)
        if self.out_path:
            try:
                from PIL import Image
                base, ext = os.path.splitext(self.out_path)
                path = f"{base}_{self.frame_index:04d}{ext or '.png'}" \
                    if self.frame_index else self.out_path
                Image.fromarray(self.last_frame).save(path)
            except Exception:
                pass
        self.frame_index += 1


_KEY_NAMES = {
    "w": "w", "a": "a", "s": "s", "d": "d", "space": "space",
    "escape": "escape", "v": "v", "t": "t", "return": "return",
    "backspace": "backspace", "left shift": "shift",
}


class PygameWindow(WindowBase):
    """SDL-backed window + input (the MainWindow role)."""

    def __init__(self, width: int, height: int, render_scale: float = 0.25,
                 title: str = "Software Renderer TPU - Dust2"):
        super().__init__(width, height, render_scale)
        import pygame
        self._pg = pygame
        pygame.display.init()
        pygame.font.init()
        self._screen = pygame.display.set_mode((width, height),
                                               pygame.RESIZABLE)
        pygame.display.set_caption(title)
        self._resize_at: Optional[float] = None
        self._resize_to: Optional[Tuple[int, int]] = None
        self._joystick = None
        self.gamepad_deadzone = 0.15
        try:
            pygame.joystick.init()
            if pygame.joystick.get_count() > 0:
                self._joystick = pygame.joystick.Joystick(0)
                self._joystick.init()
        except Exception:
            self._joystick = None

    def poll(self) -> dict:
        pg = self._pg
        chars = ""
        mouse_down = False
        quit_ = False
        for ev in pg.event.get():
            if ev.type == pg.QUIT:
                quit_ = True
            elif ev.type == pg.VIDEORESIZE:
                # debounced resize (MainWindow.cs:278-296: 0.25 s)
                self._resize_to = (max(1, ev.w), max(1, ev.h))
                self._resize_at = time.monotonic() + 0.25
            elif ev.type == pg.MOUSEBUTTONDOWN and ev.button == 1:
                mouse_down = True
            elif ev.type == pg.TEXTINPUT:
                chars += ev.text
            elif (self._joystick is None
                  and ev.type == getattr(pg, "JOYDEVICEADDED", -1)):
                try:                          # hot-plug a first controller
                    self._joystick = pg.joystick.Joystick(ev.device_index)
                    self._joystick.init()
                except Exception:
                    self._joystick = None
            elif ev.type == getattr(pg, "JOYDEVICEREMOVED", -2) \
                    and self._joystick is not None \
                    and getattr(ev, "instance_id", None) \
                    == self._joystick.get_instance_id():
                self._joystick = None
        if self._resize_at is not None \
                and time.monotonic() >= self._resize_at:
            self.width, self.height = self._resize_to
            self._screen = pg.display.set_mode((self.width, self.height),
                                               pg.RESIZABLE)
            self._resize_at = None

        pressed = pg.key.get_pressed()
        keys = set()
        for name, out in _KEY_NAMES.items():
            try:
                if pressed[pg.key.key_code(name)]:
                    keys.add(out)
            except Exception:
                pass
        dx, dy = pg.mouse.get_rel() if self.mouse_captured else (0, 0)
        return {"keys": keys, "mouse_delta": (float(dx), float(dy)),
                "mouse_down": mouse_down,
                "mouse_held": bool(pg.mouse.get_pressed()[0]),
                "mouse_pos": tuple(pg.mouse.get_pos()),
                "chars": chars, "quit": quit_,
                "gamepad": self._poll_gamepad()}

    def _poll_gamepad(self) -> Optional[dict]:
        """Map joystick 0 onto the poll() gamepad convention.

        Axis layout: left stick = axes 0/1; right stick = axes 2/3 on
        4-axis pads, 3/4 on XInput-style 6-axis pads (2/5 are triggers
        there, right trigger = axis 5).  Stick y is negated so +y means
        forward; look y stays SDL-signed (down-positive, like mouse dy).
        """
        js = self._joystick
        if js is None:
            return None
        try:
            n_ax = js.get_numaxes()
            n_bt = js.get_numbuttons()

            def ax(i):
                return float(js.get_axis(i)) if i < n_ax else 0.0

            def dz(v):
                return v if abs(v) > self.gamepad_deadzone else 0.0

            look_x, look_y = (3, 4) if n_ax >= 6 else (2, 3)
            trigger = ax(5) > 0.25 if n_ax >= 6 else False
            bumper = bool(js.get_button(5)) if n_bt > 5 else False
            return {"move": (dz(ax(0)), dz(-ax(1))),
                    "look": (dz(ax(look_x)), dz(ax(look_y))),
                    "jump": bool(js.get_button(0)) if n_bt > 0 else False,
                    "fire": trigger or bumper}
        except Exception:
            return None

    def set_mouse_capture(self, captured: bool) -> None:
        super().set_mouse_capture(captured)
        self._pg.mouse.set_visible(not captured)
        self._pg.event.set_grab(captured)
        if captured:
            self._pg.mouse.get_rel()  # swallow the first jump

    def present(self, rgb: np.ndarray, overlay=None) -> None:
        pg = self._pg
        rgb = np.asarray(rgb)
        h, w = rgb.shape[:2]
        if rgb.flags.c_contiguous and rgb.dtype == np.uint8 \
                and rgb.shape[2] == 3:
            # Zero-copy upload: frombuffer reads the row-major (h, w, 3)
            # array directly — measured 26 → 4.8 ms per 4K present vs
            # the make_surface path, whose swapaxes view forces a
            # strided copy (the local-display analog of the reference's
            # TexSubImage2D upload, MainWindow.cs:247-251).
            surf = pg.image.frombuffer(rgb, (w, h), "RGB")
        else:
            surf = pg.surfarray.make_surface(np.swapaxes(rgb, 0, 1))
        if (w, h) != (self.width, self.height):
            surf = pg.transform.scale(surf, (self.width, self.height))
        self._screen.blit(surf, (0, 0))
        if overlay is not None:
            overlay(self._screen, pg)
        pg.display.flip()

    def close(self) -> None:
        self._pg.display.quit()


def make_window(width: int, height: int, render_scale: float = 0.25,
                headless: Optional[bool] = None,
                out_path: Optional[str] = None,
                title: str = "Software Renderer TPU - Dust2") -> WindowBase:
    """Pick a backend: headless when no display or explicitly requested."""
    if headless is None:
        headless = not os.environ.get("DISPLAY") \
            and os.environ.get("SDL_VIDEODRIVER") != "dummy"
    if headless:
        return HeadlessWindow(width, height, render_scale, out_path)
    try:
        return PygameWindow(width, height, render_scale, title)
    except Exception:
        return HeadlessWindow(width, height, render_scale, out_path)
