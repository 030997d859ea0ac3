"""Audio output: WAV playback with per-sound volume, looping, id-based stop.

Role-equivalent of the reference's SDL2 audio layer (Sounds.cs, consumed
via ppy.SDL2-CS P/Invoke — SURVEY.md §2): PlaySound(path, volume, loop) →
sound id, StopSound(id), StopAllSounds(), Cleanup() (Sounds.cs:58-264).
Backed by pygame.mixer (SDL under the hood, same as the reference); the
reference's software volume scaling of PCM samples (Sounds.cs:24-38)
becomes the mixer's per-channel volume.

Headless-safe: if no audio device exists (CI, containers), the module
degrades to a silent no-op backend and keeps the same API + bookkeeping,
so game logic and tests run anywhere.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional

_mixer = None
_mixer_failed = False
_lock = threading.Lock()
_next_id = 1
_playing: Dict[int, object] = {}
_sound_cache: Dict[str, object] = {}


def _ensure_mixer() -> bool:
    """Lazy init (Sounds.cs:40-55 lazily SDL_Inits on first play)."""
    global _mixer, _mixer_failed
    if _mixer is not None:
        return True
    if _mixer_failed:
        return False
    try:
        os.environ.setdefault("SDL_AUDIODRIVER",
                              os.environ.get("SRT_AUDIO_DRIVER", "dummy")
                              if not os.environ.get("DISPLAY")
                              else "")
        import pygame
        pygame.mixer.init()
        _mixer = pygame.mixer
        return True
    except Exception:
        _mixer_failed = True
        return False


def play_sound(path: str, volume: float = 1.0, loop: bool = False,
               pan: float = 0.0) -> Optional[int]:
    """Start a WAV; returns a sound id (Sounds.cs:58-211) or None.

    pan ∈ [-1 (left), +1 (right)]: constant-power stereo panning
    (beyond the reference, whose SDL path is mono volume only)."""
    global _next_id
    if not _ensure_mixer():
        # silent backend still hands out ids so game logic proceeds
        with _lock:
            sid = _next_id
            _next_id += 1
        return sid
    try:
        with _lock:
            snd = _sound_cache.get(path)
            if snd is None:
                snd = _mixer.Sound(path)
                _sound_cache[path] = snd
        ch = snd.play(loops=-1 if loop else 0)
        if ch is not None:
            l, r = pan_gains(pan)
            v = max(0.0, min(1.0, float(volume)))
            ch.set_volume(v * l, v * r)
        with _lock:
            sid = _next_id
            _next_id += 1
            if ch is not None:
                _playing[sid] = ch
        return sid
    except Exception:
        return None


def stop_sound(sound_id: int) -> None:
    """Sounds.StopSound (:213-236)."""
    with _lock:
        ch = _playing.pop(sound_id, None)
    if ch is not None:
        try:
            ch.stop()
        except Exception:
            pass


def stop_all_sounds() -> None:
    with _lock:
        chans = list(_playing.values())
        _playing.clear()
    for ch in chans:
        try:
            ch.stop()
        except Exception:
            pass


def cleanup() -> None:
    """Sounds.Cleanup (:246-264)."""
    global _mixer
    stop_all_sounds()
    with _lock:
        _sound_cache.clear()
    if _mixer is not None:
        try:
            _mixer.quit()
        except Exception:
            pass
        _mixer = None


def pan_gains(pan: float) -> tuple:
    """Constant-power stereo gains for pan ∈ [-1, 1]: equal loudness at
    any angle (l² + r² = 1), hard left/right at the extremes."""
    import math
    pan = max(-1.0, min(1.0, float(pan)))
    a = (pan + 1.0) * (math.pi / 4.0)     # 0 → left, π/2 → right
    return math.cos(a), math.sin(a)


def direction_pan(listener_pos, listener_right, source_pos) -> float:
    """Pan from the horizontal angle of the source relative to the
    listener's right axis (the camera's right vector)."""
    import numpy as _np
    d = _np.asarray(source_pos, _np.float32) \
        - _np.asarray(listener_pos, _np.float32)
    n = float(_np.linalg.norm(d))
    if n < 1e-6:
        return 0.0
    return float(_np.clip(_np.dot(d / n,
                                  _np.asarray(listener_right,
                                              _np.float32)), -1.0, 1.0))


def shot_volume(distance: float) -> float:
    """The game's distance attenuation for gunshots
    (Renderer.cs:957-960): clamp(25 / (0.25·d), 0, 25) / 100."""
    if distance <= 0:
        return 0.25
    return max(0.0, min(25.0, 25.0 / (0.25 * distance))) / 100.0
