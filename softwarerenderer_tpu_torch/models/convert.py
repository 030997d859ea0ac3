"""Packed scene buffers -> device tensors.

``models.scene.build_scene_buffers`` (the port's copy of the JAX
package's) packs a scene into numpy arrays.  Both packages render the same
arrays: the JAX engine ``device_put``s them, the port moves them here.
Dtypes are kept as packed: the RGBA8 atlas stays uint8, ids stay int32, floats stay
float32.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def scene_to_torch(scene_np: Dict, device) -> Dict[str, torch.Tensor]:
    """Every array of a packed scene as a tensor on `device`, same dtype."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in scene_np.items()}
