"""sim.prng against jax.random: keys, split, bits, uniform and randint
bit for bit over seeds, shapes and batches of keys; normal within its
bound (XLA's log1p is not copied)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softwarerenderer_tpu_torch.sim import prng

SEEDS = (0, 1, 42, 2 ** 31 - 1, -1, 123456789)
SHAPES = ((), (3,), (2, 3, 7))
# normal against jax.random.normal over 10^6 draws: 9,337 differ, by at
# most 3 float32 ulps, 4.77e-7 absolute, 2.4e-7 relative (the float64
# log1p against XLA's own); held at 4 ulps and 1e-6.
NORMAL_ULPS = 4
NORMAL_ATOL = 1e-6


def as_key(k) -> torch.Tensor:
    return torch.from_numpy(np.asarray(k).astype(np.int64))


def bits_of(x) -> np.ndarray:
    """float32 values as their bit patterns, ints as int64."""
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x.astype(np.int64)


def test_threefry_partitionable_is_on():
    """The streams sim.prng copies are those of the partitionable
    threefry, JAX 0.9's default."""
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_bits_uniform_randint_equal_jax(seed):
    jk = jax.random.PRNGKey(seed)
    tk = prng.prng_key(seed, "cpu")
    np.testing.assert_array_equal(bits_of(jk), tk.numpy())
    for n in (1, 2, 3, 6, 7):
        np.testing.assert_array_equal(bits_of(jax.random.split(jk, n)),
                                      prng.split(tk, n).numpy())
    for shape in SHAPES:
        np.testing.assert_array_equal(
            bits_of(jax.random.bits(jk, shape)),
            prng.random_bits(tk, shape).numpy())
        for lo, hi in ((0.0, 1.0), (1.2, 2.0)):
            got = prng.uniform(tk, shape, lo, hi).numpy()
            want = np.asarray(jax.random.uniform(jk, shape, minval=lo,
                                                 maxval=hi))
            assert got.shape == want.shape
            np.testing.assert_array_equal(bits_of(want), bits_of(got))
        for lo, hi in ((1, 33), (-5, 7), (3, 3), (-2 ** 31, 2 ** 31 - 1)):
            got = prng.randint(tk, shape, lo, hi).numpy()
            want = np.asarray(jax.random.randint(jk, shape, lo, hi))
            assert got.dtype == want.dtype == np.int32
            np.testing.assert_array_equal(want, got)


def test_batched_keys_equal_vmap():
    """A batch of keys draws what jax.vmap over them draws (the agents'
    per-agent streams)."""
    keys = jax.random.split(jax.random.PRNGKey(7), 5)
    tk = as_key(keys)
    np.testing.assert_array_equal(
        bits_of(jax.vmap(lambda k: jax.random.split(k, 6))(keys)),
        prng.split(tk, 6).numpy())
    np.testing.assert_array_equal(
        bits_of(jax.vmap(lambda k: jax.random.uniform(k, ()))(keys)),
        bits_of(prng.uniform(tk).numpy()))
    np.testing.assert_array_equal(
        bits_of(jax.vmap(lambda k: jax.random.randint(k, (), 1, 33))(keys)),
        prng.randint(tk, (), 1, 33).numpy())
    np.testing.assert_array_equal(
        bits_of(jax.vmap(lambda k: jax.random.bits(k, (2, 3)))(keys)),
        prng.random_bits(tk, (2, 3)).numpy())
    stacked = torch.stack([tk, tk.flip(0)])                   # (2, 5, 2)
    np.testing.assert_array_equal(
        prng.uniform(stacked, (4,))[1].numpy(),
        prng.uniform(tk.flip(0), (4,)).numpy())
    nrm = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (3,)))(keys))
    np.testing.assert_allclose(prng.normal(tk, 3).numpy(), nrm, rtol=0,
                               atol=NORMAL_ATOL)


def test_normal_within_its_bound():
    """10^6 normal draws against jax.random.normal: at most NORMAL_ULPS
    float32 ulps and NORMAL_ATOL apart; most bit-equal."""
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (10 ** 6,)))
    got = prng.normal(prng.prng_key(3, "cpu"), (10 ** 6,)).numpy()
    ulps = np.abs(bits_of(want).astype(np.int64)
                  - bits_of(got).astype(np.int64))
    assert ulps.max() <= NORMAL_ULPS, ulps.max()
    assert np.abs(got - want).max() <= NORMAL_ATOL
    assert (ulps == 0).mean() > 0.98


def test_erf_inv_edges_equal_xla():
    """erf_inv at 0, ±1 (±inf) and both branches of w = -log1p(-x²)."""
    x = np.float32([0.0, -0.0, 1.0, -1.0, 0.5, -0.99999994, 0.999, 0.3])
    got = prng.erf_inv(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got, want, rtol=1e-6)
