"""The port's threefry2x32 against ``jax.random`` in legacy mode, bit for bit.

``prng_key``, ``split`` and ``uniform`` must reproduce
``jax.random.PRNGKey``/``split``/``uniform`` with
``jax_threefry_partitionable=False`` — the mode the simulator's golden
constants were captured in.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch.core.netsim import prng

SEEDS = [0, 1, 3, 7, 42, 1234, 65536, 99991, 2**31 - 1]
SHAPES = [(32, 64), (128, 64), (7,), (3, 5), (1,), (2, 3, 5)]


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split_chain(seed):
    with jax.threefry_partitionable(False):
        k = jax.random.PRNGKey(seed)
        kt = prng.prng_key(seed, "cpu")
        assert np.array_equal(np.asarray(k).astype(np.int64), kt.numpy())
        for _ in range(12):
            k, sub = jax.random.split(k)
            kt, subt = prng.split(kt)
            assert np.array_equal(np.asarray(k).astype(np.int64), kt.numpy())
            assert np.array_equal(np.asarray(sub).astype(np.int64),
                                  subt.numpy())


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_uniform_bits(shape):
    with jax.threefry_partitionable(False):
        for seed in SEEDS:
            _, sub = jax.random.split(jax.random.PRNGKey(seed))
            _, subt = prng.split(prng.prng_key(seed, "cpu"))
            want = np.asarray(jax.random.uniform(sub, shape))
            got = prng.uniform(subt, shape).numpy()
            assert got.dtype == np.float32
            assert np.array_equal(want, got), seed


def test_lane_batched_keys():
    """A ``[S, 2]`` key stack gives each lane its own stream."""
    seeds = [0, 5, 9]
    with jax.threefry_partitionable(False):
        keys = prng.prng_key(seeds, "cpu")
        new, sub = prng.split(keys)
        u = prng.uniform(sub, (4, 6))
        assert u.shape == (3, 4, 6)
        for i, s in enumerate(seeds):
            k, sb = jax.random.split(jax.random.PRNGKey(s))
            assert np.array_equal(np.asarray(k).astype(np.int64),
                                  new[i].numpy())
            assert np.array_equal(np.asarray(jax.random.uniform(sb, (4, 6))),
                                  u[i].numpy())
