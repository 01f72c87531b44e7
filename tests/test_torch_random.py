"""PyTorch port, RNG: ops.random against jax.random, bit for bit.

The render's jitter comes from key -> split -> per-ray fold_in -> uniform;
matching every step exactly is what lets the port's images equal the JAX
package's committed goldens."""

import jax
import numpy as np
import pytest
import torch

from nerf_rs_tpu_torch.ops import random

torch.set_num_threads(1)

SEEDS = [0, 1, 42, 12345, 2**31 - 1]
RAY_IDS = np.array([0, 1, 2, 7, 255, 4096, 65535, 123456, 2**20 - 1, 2**20], np.int32)


def _data(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_matches_jax(seed):
    np.testing.assert_array_equal(random.key(seed, "cpu").numpy(), _data(jax.random.key(seed)))


@pytest.mark.parametrize("seed", SEEDS)
def test_split_matches_jax(seed):
    got = random.split(random.key(seed, "cpu"))
    np.testing.assert_array_equal(got.numpy(), _data(jax.random.split(jax.random.key(seed))))


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_per_ray_matches_jax(seed):
    k_c, _ = jax.random.split(jax.random.key(seed))
    want = jax.vmap(lambda i: jax.random.fold_in(k_c, i))(RAY_IDS)
    k = random.split(random.key(seed, "cpu"))[0]
    got = random.fold_in(k, torch.from_numpy(RAY_IDS.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), _data(want))


@pytest.mark.parametrize("count", [16, 64, 128])
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_per_ray_matches_jax(seed, count):
    _, k_f = jax.random.split(jax.random.key(seed))
    keys = jax.vmap(lambda i: jax.random.fold_in(k_f, i))(RAY_IDS)
    want = np.asarray(jax.vmap(lambda kk: jax.random.uniform(kk, (count,)))(keys))
    k = random.split(random.key(seed, "cpu"))[1]
    got = random.uniform(random.fold_in(k, torch.from_numpy(RAY_IDS.astype(np.int64))),
                         (len(RAY_IDS), count))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_single_key_matches_jax(seed):
    want = np.asarray(jax.random.uniform(jax.random.key(seed), (6, 33)))
    np.testing.assert_array_equal(random.uniform(random.key(seed, "cpu"), (6, 33)).numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_range_matches_jax(seed):
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    want = np.asarray(jax.random.uniform(jax.random.key(seed), (512, 3), minval=lo, maxval=1.0))
    got = random.uniform(random.key(seed, "cpu"), (512, 3), lo, 1.0)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_matches_jax(seed):
    """The same uniform bits through XLA's erf_inv polynomial: equal to
    jax.random.normal but for the rounding of log1p and the multiply-adds,
    within 2 ulps (relative 2.5e-7)."""
    want = np.asarray(jax.random.normal(jax.random.key(seed), (4096, 3)))
    got = random.normal(random.key(seed, "cpu"), (4096, 3))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2.5e-7, atol=0)


def test_uniform_rejects_mismatched_batch():
    keys = random.fold_in(random.key(0, "cpu"), torch.arange(4))
    with pytest.raises(ValueError, match="per-ray keys"):
        random.uniform(keys, (5, 8))
