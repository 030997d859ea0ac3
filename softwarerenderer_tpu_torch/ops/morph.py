"""Morph targets (blend shapes): each morphing vertex moves by the weighted
sum of its targets' deltas.

Counterpart of ``softwarerenderer_tpu/ops/morph.py``.  The deltas are
packed vertex-major ((Vm, K, 3), models.scene.build_scene_buffers); the
weights are (S, K) per morphing mesh slot, taken in this order of
precedence:

  1. ``uniforms["morph_weights"]``, broadcast to (S, K);
  2. each slot's uniform-clock weight track sampled at
     ``uniforms["morph_time"]`` (scalar or (S,)), else at
     ``uniforms["anim_time"]``, two keys and a lerp (slots without a track
     keep their defaults).  An ``anim_time`` whose length is neither 1 nor
     S is the per-skin clock vector of ops.skinning: every slot then reads
     its first element;
  3. the packed defaults.

Applied before skinning (the glTF order).  The weighted sums run left to
right over the K targets, with correctly rounded roots (ml.sqrt_rn), and
never write into the scene's buffers, so a frame equals itself on the CPU
and on the card, whatever frames came before.  ``morphed_positions_np``
is the host (numpy) reference the packer bounds morphing meshes with.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from softwarerenderer_tpu_torch.utils import mathlib as ml

F32 = torch.float32


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F32, device=device)


def frame_index(frame: torch.Tensor, n_frames: torch.Tensor):
    """(i0, i1, a): the keys either side of a fractional `frame` on a
    looping clip of n_frames keys (at least 1), floor modulo, and the lerp
    weight frame - floor(frame) as (..., 1).  floor(frame) casts to int32
    as XLA's convert does (ml.xla_int32): NaN to 0, saturating."""
    nf = n_frames.clamp(min=1)
    f0 = torch.floor(frame)
    i0 = torch.remainder(ml.xla_int32(f0), nf)
    i1 = torch.remainder(i0 + 1, nf)
    return i0.long(), i1.long(), (frame - f0)[..., None]


def morph_weights(scene: Dict[str, torch.Tensor], uniforms: Dict
                  ) -> torch.Tensor:
    """(S, K) blend weights per morphing mesh slot, by the precedence of
    the module docstring."""
    dflt = scene["morph_default_weights"]
    S, K = dflt.shape
    dev = dflt.device
    if "morph_weights" in uniforms:
        w = _f32(uniforms["morph_weights"], dev)
        return torch.atleast_2d(w).expand(S, K)
    w = dflt
    if "morph_weight_tracks" in scene:
        t = uniforms.get("morph_time", uniforms.get("anim_time", 0.0))
        t = _f32(t, dev).reshape(-1)
        t = (t if t.shape[0] in (1, S) else t[:1]).expand(S)
        nf = scene["morph_track_frames"]
        i0, i1, a = frame_index(t * scene["morph_rate"], nf)
        tr = scene["morph_weight_tracks"]                    # (S, F, K)
        s = torch.arange(S, device=dev)
        k0, k1 = tr[s, i0], tr[s, i1]
        w = torch.where((nf > 0)[:, None], k0 + (k1 - k0) * a, w)
    return w


def weighted_deltas(deltas: torch.Tensor, wv: torch.Tensor) -> torch.Tensor:
    """Σ_k deltas[:, k] · wv[:, k], summed left to right over K."""
    acc = deltas[:, 0] * wv[:, 0:1]
    for k in range(1, deltas.shape[1]):
        acc = acc + deltas[:, k] * wv[:, k:k + 1]
    return acc


def renormalize(n: torch.Tensor) -> torch.Tensor:
    """n / sqrt(max(n·n, 1e-30)), the dot summed left to right and the
    root correctly rounded (ml.sqrt_rn)."""
    return n / ml.sqrt_rn(ml.dot(n, n).clamp(min=1e-30))[..., None]


def apply_morphs(vin: Dict, scene: Dict[str, torch.Tensor],
                 uniforms: Dict) -> Dict:
    """A copy of vin with the morphing vertices' positions (and normals,
    renormalised, when the scene has normal deltas) displaced by their
    weighted target deltas."""
    vidx = scene["morph_vert_index"].long()
    wv = morph_weights(scene, uniforms)[scene["morph_slot"].long()]
    out = dict(vin)
    new_pos = vin["position"][vidx] + weighted_deltas(
        scene["morph_deltas_pos"], wv)
    out["position"] = vin["position"].index_put((vidx,), new_pos)
    if "morph_deltas_nrm" in scene:
        n = vin["normal"][vidx] + weighted_deltas(scene["morph_deltas_nrm"],
                                                  wv)
        out["normal"] = vin["normal"].index_put((vidx,), renormalize(n))
    return out


def morphed_positions_np(morph: Dict, positions: np.ndarray,
                         weights: np.ndarray) -> np.ndarray:
    """Host reference: one instance's morphed positions under explicit
    (K,) weights (the packer's conservative bounds)."""
    dp = np.asarray(morph["pos"], np.float32)                # (K, V, 3)
    w = np.asarray(weights, np.float32).reshape(-1)[: dp.shape[0]]
    return np.asarray(positions, np.float32) + np.einsum("kvc,k->vc", dp, w)
