"""Host values to the device in one copy that does not wait for the card.

``tensor.to("cuda")`` from ordinary host memory copies and then waits for
the stream to drain, so each small upload of a frame's inputs costs a host
synchronisation.  ``upload`` lays every array of a nested dict out in one
pinned host buffer, copies it with ``non_blocking=True`` and returns the
same tree of views into the one device buffer.  PyTorch's pinned-memory
allocator records the copy on the buffer, so the buffer is not handed out
again before the copy has run, and a new call never overwrites the inputs
of a copy still in flight.  On the CPU the buffer is the tensors' storage:
the same code path, with no copy.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

_ALIGN = 8          # every leaf starts on an 8-byte boundary


def _layout(tree: Any, offset: int, out: list) -> int:
    """Append (array, offset) for every host leaf of `tree` in order;
    returns the end offset."""
    if isinstance(tree, dict):
        for v in tree.values():
            offset = _layout(v, offset, out)
        return offset
    if isinstance(tree, torch.Tensor):
        return offset
    a = np.asarray(tree)
    if a.dtype == np.float64:
        a = a.astype(np.float32)       # the JAX package's default precision
    out.append((np.asarray(a, order="C"), offset))
    return offset + -(-a.nbytes // _ALIGN) * _ALIGN


def _views(tree: Any, buf: torch.Tensor, leaves: iter) -> Any:
    if isinstance(tree, dict):
        return {k: _views(v, buf, leaves) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree
    a, off = next(leaves)
    dtype = torch.from_numpy(a.reshape(-1)[:0]).dtype
    return buf[off:off + a.nbytes].view(dtype).reshape(a.shape)


def upload(tree: Any, device) -> Any:
    """`tree` (a nested dict of host arrays and numbers, or one of them)
    as tensors on `device`, dtypes kept (float64 as float32), in one
    host-to-device copy issued with non_blocking=True from pinned memory.
    Tensors in the tree are passed through as they are."""
    device = torch.device(device)
    leaves: list = []
    total = _layout(tree, 0, leaves)
    host = torch.empty(max(total, _ALIGN), dtype=torch.uint8,
                       pin_memory=device.type == "cuda")
    hb = host.numpy()
    for a, off in leaves:
        hb[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)
    buf = host.to(device, non_blocking=True)
    return _views(tree, buf, iter(leaves))
