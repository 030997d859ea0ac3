"""Packed scene buffers and simulation states -> device tensors, and back.

``models.scene.build_scene_buffers`` (the port's copy of the JAX
package's) packs a scene into numpy arrays.  Both packages render the same
arrays: the JAX engine ``device_put``s them, the port moves them here.
Dtypes are kept as packed: the RGBA8 atlas stays uint8, ids stay int32, floats stay
float32.

The simulation states (``sim.character``, ``sim.particles``,
``sim.agents``) carry the JAX package's leaves with two differences:
a PRNG key (a leaf named "key") holds its two uint32 words in int64
(``sim.prng``), and a character state has a leading N axis, N = 1 for
the JAX package's single character.  ``state_to_torch`` and
``state_to_numpy`` carry a state across, so both packages can step from
the same state.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

# A character state's leaves (sim.character.initial_character_state).
_CHARACTER_KEYS = frozenset(("position", "velocity", "grounded", "ceiling",
                             "jump_cooldown", "actual_step", "noclip"))


def scene_to_torch(scene: Dict, device) -> Dict[str, torch.Tensor]:
    """Every array of a packed scene as a tensor on `device`, same dtype.
    A tensor already on `device` is kept as it is, not copied, so an
    engine rebuilt from another's scene (``Engine(old.scene, ...)``)
    shares its buffers."""
    return {k: v.to(device) if isinstance(v, torch.Tensor)
            else torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in scene.items()}


def tree_to_torch(tree: Any, device) -> Any:
    """A nested dict of arrays and numbers as tensors on `device`, dtypes
    kept (float64 as float32, the JAX package's precision); tensors are
    moved.  The simulation's tunables go to the device once this way."""
    if isinstance(tree, dict):
        return {k: tree_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    a = np.array(tree)                     # a copy; 0-d stays 0-d
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(a).to(device)


def _is_character(tree: Dict) -> bool:
    return _CHARACTER_KEYS.issubset(tree)


def state_to_torch(state: Any, device) -> Any:
    """A JAX package simulation state (numpy or JAX arrays) as the port's:
    tensors on `device`, uint32 keys in int64, and a single character's
    leaves (position (3,)) given a leading axis of 1."""
    if isinstance(state, dict):
        single = _is_character(state) and np.ndim(state["position"]) == 1
        out = {}
        for k, v in state.items():
            if isinstance(v, dict):
                out[k] = state_to_torch(v, device)
                continue
            a = np.array(v)                # a copy; 0-d stays 0-d
            if k == "key":
                a = a.astype(np.int64)
            if single:
                a = a[None]
            out[k] = torch.from_numpy(a).to(device)
        return out
    return torch.from_numpy(np.array(state)).to(device)


def state_to_numpy(state: Any, single: bool = False) -> Any:
    """The port's simulation state as the JAX package's, in numpy: keys
    back to uint32, and with `single` a character state's leading axis
    of 1 dropped (the JAX package's one character)."""
    if isinstance(state, dict):
        drop = single and _is_character(state)
        out = {}
        for k, v in state.items():
            if isinstance(v, dict):
                out[k] = state_to_numpy(v, single)
                continue
            a = v.detach().cpu().numpy()
            if k == "key":
                a = a.astype(np.uint32)
            out[k] = a[0] if drop else a
        return out
    return state.detach().cpu().numpy()
