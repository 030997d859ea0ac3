"""Checkpoint and resume of simulation and game state.

Counterpart of ``softwarerenderer_tpu/utils/checkpoint.py``'s numpy half:
``save`` writes a nested dict / list / tuple of tensors, arrays, scalars,
strings and None to one ``.npz`` (tensors as numpy arrays, read back from
their device; the write is atomic), and ``load`` restores it, its arrays
as tensors on the device the caller names.  A simulation state
(``sim.character``, ``sim.particles``, ``sim.agents``) saved and loaded
steps on exactly as the unbroken run does.  The JAX package's orbax
backend (``save_orbax`` / ``load_orbax``) is not ported: orbax is a JAX
library, and the machines the port runs on do not have it.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch


def _flatten(tree: Any, prefix: str, out: Dict[str, np.ndarray],
             meta: Dict[str, Any]) -> None:
    if isinstance(tree, dict):
        meta[prefix + "/__type__"] = "dict"
        meta[prefix + "/__keys__"] = sorted(tree.keys())
        for k in sorted(tree.keys()):
            _flatten(tree[k], f"{prefix}/{k}", out, meta)
    elif isinstance(tree, (list, tuple)):
        meta[prefix + "/__type__"] = ("list" if isinstance(tree, list)
                                      else "tuple")
        meta[prefix + "/__len__"] = len(tree)
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}/{i}", out, meta)
    elif isinstance(tree, (str, type(None))):
        meta[prefix + "/__type__"] = "json"
        meta[prefix + "/__value__"] = tree
    else:
        meta[prefix + "/__type__"] = "array"
        out[prefix] = (tree.detach().cpu().numpy()
                       if isinstance(tree, torch.Tensor) else np.asarray(tree))


def _unflatten(prefix: str, data, meta: Dict[str, Any], device) -> Any:
    t = meta[prefix + "/__type__"]
    if t == "dict":
        return {k: _unflatten(f"{prefix}/{k}", data, meta, device)
                for k in meta[prefix + "/__keys__"]}
    if t in ("list", "tuple"):
        items = [_unflatten(f"{prefix}/{i}", data, meta, device)
                 for i in range(meta[prefix + "/__len__"])]
        return items if t == "list" else tuple(items)
    if t == "json":
        return meta[prefix + "/__value__"]
    a = data[prefix]
    return a if device is None else torch.from_numpy(a).to(device)


def save(path: str, state: Any) -> None:
    """Save a tree of tensors, arrays, scalars and strings to one .npz."""
    arrays: Dict[str, np.ndarray] = {}
    meta: Dict[str, Any] = {}
    _flatten(state, "root", arrays, meta)
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)  # atomic: a crash never corrupts the checkpoint


def load(path: str, device: Optional[Any] = None) -> Any:
    """Restore the tree saved by save(): its arrays as tensors on
    `device`, or as numpy arrays when device is None."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]).decode("utf-8"))
        data = {k: z[k] for k in z.files if k != "__meta__"}
    return _unflatten("root", data, meta, device)
