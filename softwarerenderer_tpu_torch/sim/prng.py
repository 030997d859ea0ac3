"""The ``jax.random`` draws the simulation uses, as torch integer code.

Counterpart of ``jax.random`` with JAX's default threefry2x32 PRNG:
``prng_key`` is ``PRNGKey``, and ``split``, ``random_bits``, ``uniform``,
``normal`` and ``randint`` draw the same streams bit for bit (``normal``
within ``erf_inv``'s bound below).  The algorithms are JAX's
(``jax/_src/prng.py``: ``threefry_seed``, ``threefry_2x32``,
``_threefry_split_foldlike``, ``_threefry_random_bits_partitionable``;
``jax/_src/random.py``: ``_uniform``, ``_normal_real``, ``_randint``),
under ``jax_threefry_partitionable=True``, JAX 0.9's default:
a draw of shape S hashes the 64-bit iota over S, split into (high, low)
words, and ``split`` is a draw of shape (n,) kept as (bits1, bits2)
pairs.  Under the older ``False`` setting JAX's streams differ.

A key is a (..., 2) int64 tensor holding the two uint32 words (torch has
no unsigned ``>>`` on the CPU).  Every function takes one key or a batch
of keys, as ``jax.vmap`` over keys would, and returns the batch's shape
followed by the draw's.  The hash is adds, rotations and xors of 32-bit
words held in int64 with explicit wraps, so a draw is the same on the
CPU and on the card, and runs on the keys' device.

``normal`` is ``sqrt(2) · erf_inv(u)`` with XLA's float32 ``erf_inv``
(Giles' polynomials, evaluated by XLA as fused multiply-adds, each
emulated here in float64).  Its ``log1p`` is XLA's own
approximation, which this module does not copy: the float64 ``log1p``
rounded to float32 differs from it by an ulp on about 8 % of inputs, so
a normal draw may sit a few float32 ulps from JAX's
(tests/test_torch_prng.py states the bound).  torch's float32 ``log1p``
may round differently on the CPU and on CUDA, and its vectorised CPU
``sqrt`` is not correctly rounded; the float64 ``log1p`` rounded to
float32 and ``ml.sqrt_rn`` make a draw the same on both (chip_smoke.py
phase 22d compares 10^6 of each).
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from softwarerenderer_tpu_torch.utils import mathlib as ml

M32 = 0xFFFFFFFF
I64 = torch.int64
F32 = torch.float32
F64 = torch.float64

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# Giles' single-precision erfinv (XLA's ErfInv32): the coefficients for
# w = -log1p(-x²) < 5 and >= 5, highest power first.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
# normal's uniform range (nextafter(-1, 0), 1) and its scale sqrt(2), as
# float32 values.
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> tuple:
    return (int(shape),) if isinstance(shape, (int, np.integer)) \
        else tuple(int(s) for s in shape)


def prng_key(seed: int, device="cuda") -> torch.Tensor:
    """jax.random.PRNGKey(seed) as a (2,) int64 key on `device`: [0, seed]
    for a seed that fits int32 (its low word two's complement), the two
    words of a 64-bit seed otherwise."""
    seed = int(seed)
    hi = 0 if -2 ** 31 <= seed < 2 ** 31 else (seed >> 32) & M32
    return torch.tensor([hi, seed & M32], dtype=I64, device=device)


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & M32


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 (20 rounds) of the count words (x1, x2) under the key
    words (k1, k2): uint32 values in int64 tensors, broadcast together.
    Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0, x1 = (x1 + ks[0]) & M32, (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def _hash_iota(key: torch.Tensor, shape: tuple):
    """threefry2x32 of the 64-bit iota over `shape` under every key of the
    batch: two (*batch, *shape) word tensors."""
    n = int(np.prod(shape, dtype=np.int64))
    iota = torch.arange(n, dtype=I64, device=key.device).reshape(shape)
    lead = key.shape[:-1]
    pad = (1,) * len(shape)
    k1 = key[..., 0].reshape(lead + pad)
    k2 = key[..., 1].reshape(lead + pad)
    return threefry2x32(k1, k2, iota >> 32, iota & M32)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """jax.random.split: (..., 2) keys -> (..., num, 2)."""
    b1, b2 = _hash_iota(key, (int(num),))
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """jax.random.bits at 32 bits: (*batch, *shape) uint32 values in
    int64."""
    b1, b2 = _hash_iota(key, _shape(shape))
    return b1 ^ b2


def _unit_floats(bits: torch.Tensor) -> torch.Tensor:
    """[0, 1) floats from the top 23 bits: 1.mantissa - 1."""
    one_exp = 0x3F800000
    return ((bits >> 9) | one_exp).to(torch.int32).view(F32) - 1.0


def uniform(key: torch.Tensor, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """jax.random.uniform (float32): max(minval, fma(f, maxval - minval,
    minval)) for f in [0, 1), the multiply-add fused as jitted XLA fuses
    it (on [0, 1) and normal's range the product is exact, so fused and
    unfused agree).  minval and maxval are Python floats, taken as
    float32."""
    f = _unit_floats(random_bits(key, shape))
    lo = torch.full((), float(np.float32(minval)), dtype=F32, device=f.device)
    span = torch.full((), float(np.float32(maxval) - np.float32(minval)),
                      dtype=F32, device=f.device)
    return torch.maximum(_fma32(f, span, lo), lo)


def _int64(v, device) -> torch.Tensor:
    """An int or int tensor as int64 on `device`; a Python int is filled
    there, not copied from the host (a copy would wait for the card)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=I64)
    return torch.full((), int(v), dtype=I64, device=device)


def randint(key: torch.Tensor, shape: Shape, minval, maxval) -> torch.Tensor:
    """jax.random.randint (int32): two 32-bit draws folded into
    [minval, maxval) by JAX's double-width modulus (biased as JAX's is).
    minval and maxval are ints or int tensors broadcast to `shape`."""
    hi, lo = random_bits(split(key, 2), shape).unbind(key.dim() - 1)
    minval, maxval = (_int64(v, key.device) for v in (minval, maxval))
    span = (maxval - minval) & M32
    span = torch.where(maxval <= minval, torch.ones_like(span), span)
    mult = (2 ** 16) % span
    mult = ((mult * mult) & M32) % span                  # uint32 wrap
    off = ((hi % span) * mult + lo % span) & M32
    off = off % span
    out = ((minval + off + 2 ** 31) & M32) - 2 ** 31      # int32 wrap
    return out.to(torch.int32)


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """float32 fma(a, b, c): the float64 product of two float32 values is
    exact, so one float64 add and one rounding to float32 give the fused
    result (a double rounding of the sum is the only, rare, difference)."""
    return (a.to(F64) * b.to(F64) + c.to(F64)).to(F32)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erf_inv: w = -log1p(-x²); Giles' polynomial in
    w - 2.5 (w < 5) or sqrt(w) - 3 by Horner's rule in fused
    multiply-adds; times x; ±inf at x = ±1."""
    w = -torch.log1p((-x * x).to(F64)).to(F32)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, ml.sqrt_rn(w) - 3.0)
    coeff = [torch.where(lt, a, b) for a, b in zip(_ERFINV_LT5, _ERFINV_GE5)]
    p = coeff[0]
    for c in coeff[1:]:
        p = _fma32(p, w, c)
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """jax.random.normal (float32): sqrt(2) · erf_inv(u), u uniform on
    (nextafter(-1, 0), 1)."""
    return _SQRT2 * erf_inv(uniform(key, shape, _NORMAL_LO, 1.0))
