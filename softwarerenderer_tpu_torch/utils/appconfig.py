"""Config system: JSON file + env overrides + live-tunable dataclass.

The reference has no config files or flag parser — one positional CLI arg,
a Playername.txt, hardcoded constants, and live ImGui sliders for ~25
parameters (SURVEY.md §5).  Here the same tunables are one dataclass,
loadable from JSON ("srt.json" next to the app or --config), overridable
from SRT_* environment variables, and safely round-trippable — while the
render/physics values themselves remain TRACED uniforms so live tuning
never recompiles (engine.renderer docstring).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple


@dataclasses.dataclass
class AppConfig:
    # window / present (MainWindow.cs:49, Renderer.cs:74)
    width: int = 800
    height: int = 600
    render_scale: float = 0.25
    # camera / raster (Renderer.cs:46, Rasterizer.cs:20-22)
    fov_degrees: float = 90.0
    near_clip: float = 0.1
    far_clip: float = 1000.0
    sensitivity: float = 0.1
    # fog / light / clear (Renderer.cs:39-45)
    fog_start: float = 1.0
    fog_end: float = 25.0
    fog_color: Tuple[float, float, float, float] = (1.0, 0.62, 0.5, 1.0)
    light_euler_degrees: Tuple[float, float, float] = (-45.0, -45.0, 0.0)
    light_color: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    clear_color: Tuple[float, float, float, float] = \
        (0.9137, 0.7098, 0.6588, 1.0)
    # character controller (CharacterController.cs:21-33)
    gravity_y: float = -14.0
    char_height: float = 0.5
    char_radius: float = 0.15
    step_size: float = 0.3
    move_speed: float = 5.0
    jump_force: float = 4.0
    ground_acceleration: float = 3.5
    air_acceleration: float = 0.35
    max_air_speed: float = 6.0
    ground_friction: float = 6.0
    air_control: float = 0.2
    # networking (Networking.cs:71)
    server: str = "127.0.0.1"
    port: int = 7777
    player_name: Optional[str] = None
    # assets
    assets_dir: Optional[str] = None

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())


def load(path: Optional[str] = None, env: bool = True) -> AppConfig:
    """Defaults ← JSON file (if present) ← SRT_* env overrides."""
    cfg = AppConfig()
    if path is None and os.path.exists("srt.json"):
        path = "srt.json"
    if path is not None and os.path.exists(path):
        with open(path) as f:
            data = json.load(f)
        fields = {f.name: f for f in dataclasses.fields(AppConfig)}
        clean = {}
        for k, v in data.items():
            if k in fields:
                clean[k] = tuple(v) if isinstance(v, list) else v
        cfg = dataclasses.replace(cfg, **clean)
    if env:
        for f in dataclasses.fields(AppConfig):
            key = "SRT_" + f.name.upper()
            if key in os.environ:
                raw = os.environ[key]
                cur = getattr(cfg, f.name)
                if isinstance(cur, bool):
                    val = raw.lower() in ("1", "true", "yes")
                elif isinstance(cur, int):
                    val = int(raw)
                elif isinstance(cur, float):
                    val = float(raw)
                elif isinstance(cur, tuple):
                    val = tuple(float(x) for x in raw.split(","))
                else:
                    val = raw
                cfg = dataclasses.replace(cfg, **{f.name: val})
    return cfg
