"""The port's threefry2x32 against jax.random, bit for bit.

Keys (PRNGKey, chained fold_in, split) and the bulk uniform at the
shapes a frame draws: camera jitter (n, 2), Fresnel and roulette (n,),
and shared per-granule draws (n // 1024, 2).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from cuda_raytracer_tpu_torch import rng


def _key(k):
    return tuple(int(x) for x in np.asarray(k))


@pytest.mark.parametrize("seed", [0, 1, 15618, 2**31 - 1, -7])
def test_prngkey(seed):
    assert rng.PRNGKey(seed) == _key(jax.random.PRNGKey(seed))


def test_fold_in_chain_and_split():
    """The frame's key tree: frame index, then depth / sample / light."""
    kj, kp = jax.random.PRNGKey(15618), rng.PRNGKey(15618)
    for data in (3, 1000, 0, 2, 17, 3001, 2**32 - 1):
        kj, kp = jax.random.fold_in(kj, data), rng.fold_in(kp, data)
        assert kp == _key(kj)
    for num in (2, 3):
        assert rng.split(kp, num) == [_key(k) for k in
                                      jax.random.split(kj, num)]


@pytest.mark.parametrize("shape", [(4096, 2), (4096,), (4, 2), (777,),
                                   (3, 5, 2)])
def test_uniform_bits(shape):
    kj = jax.random.fold_in(jax.random.PRNGKey(15618), 2001)
    want = np.asarray(jax.random.uniform(kj, shape, dtype=jnp.float32))
    got = rng.uniform(_key(kj), shape, "cpu").numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert got.min() >= 0.0 and got.max() < 1.0

