"""PyTorch port, ray and volume ops against their JAX counterparts (f32,
atol 1e-6), on the same numpy inputs and the same random keys."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_rs_tpu.io.golden import camera_from_golden as jax_camera_from_golden
from nerf_rs_tpu.io.golden import load_golden
from nerf_rs_tpu.models.encoding import positional_encoding as jax_positional_encoding
from nerf_rs_tpu.ops import rays as jax_rays
from nerf_rs_tpu.ops import sampling as jax_sampling
from nerf_rs_tpu.ops import volume as jax_volume
from nerf_rs_tpu_torch.io.golden import camera_from_golden
from nerf_rs_tpu_torch.models.encoding import positional_encoding
from nerf_rs_tpu_torch.ops import random, rays, sampling, volume

torch.set_num_threads(1)

ATOL = 1e-6
GOLDEN = Path(__file__).resolve().parents[1] / "assets" / "lego_rust" / "tf_reference_samples.json"


def _keys(seed, n):
    """Per-ray keys, the same in both packages."""
    ids = np.arange(n, dtype=np.int32) * 3 + 5
    jk = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(seed), i))(ids)
    tk = random.fold_in(random.key(seed, "cpu"), torch.from_numpy(ids.astype(np.int64)))
    return jk, tk


def _ts_weights(rng, n, s, floor):
    ts = np.sort(rng.uniform(2.0, 6.0, size=(n, s)), axis=-1).astype(np.float32)
    w = rng.uniform(floor, 1.0, size=(n, s)).astype(np.float32)
    return ts, w


@pytest.mark.parametrize("num_freqs", [4, 10])
def test_positional_encoding_matches_jax(num_freqs):
    x = np.random.default_rng(0).uniform(-4, 4, size=(5, 7, 3)).astype(np.float32)
    got = positional_encoding(torch.from_numpy(x), num_freqs).numpy()
    want = np.asarray(jax_positional_encoding(jnp.asarray(x), num_freqs))
    assert got.shape == want.shape == (5, 7, 3 + 6 * num_freqs)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_camera_rays_match_jax():
    g = load_golden(GOLDEN)
    o, d = rays.camera_rays(camera_from_golden(g), 24, 32, "cpu")
    jo, jd = jax_rays.camera_rays(jax_camera_from_golden(g), 24, 32)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=ATOL, rtol=0)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=ATOL, rtol=0)


def test_stratified_samples_match_jax():
    jk, tk = _keys(3, 10)
    near, far = np.float32(2.0), np.float32(6.0)
    got = sampling.stratified_samples(tk, torch.tensor(near), torch.tensor(far), 16, (10,))
    want = jax_sampling.stratified_samples(jk, jnp.asarray(near), jnp.asarray(far), 16, (10,))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("t_threshold", [1e-4, 0.0])
def test_compute_weights_match_jax(t_threshold):
    rng = np.random.default_rng(1)
    ts, _ = _ts_weights(rng, 12, 24, 0.0)
    sig = rng.exponential(3.0, size=(12, 24)).astype(np.float32)
    sig[:4] *= 50.0        # opaque rays hit the early-out
    got = volume.compute_weights(torch.from_numpy(sig), torch.from_numpy(ts),
                                 torch.tensor(np.float32(6.0)), t_threshold=t_threshold)
    want = jax_volume.compute_weights(jnp.asarray(sig), jnp.asarray(ts), np.float32(6.0),
                                      t_threshold=t_threshold)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_importance_samples_match_jax():
    """Every bin carries real mass here, so the in-bin interpolation does
    not amplify f32 summation-order noise in the CDF. The samples lie in
    [2, 6], where an f32 ulp is up to 4.8e-7 and the two PDF
    normalizations, summed in different orders, move a few ulps: hence a
    relative term of 1e-6 beside the absolute one."""
    rng = np.random.default_rng(2)
    ts, w = _ts_weights(rng, 10, 16, 0.05)
    jk, tk = _keys(4, 10)
    got = sampling.importance_samples(tk, torch.from_numpy(ts), torch.from_numpy(w), 32)
    want = jax_sampling.importance_samples(jk, jnp.asarray(ts), jnp.asarray(w), 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=1e-6)


def test_importance_bin_choice_equals_one_hot():
    """searchsorted picks the bin the one-hot contraction picks — the
    first j with cdf[j] <= u < cdf[j+1] — also where most weights are zero
    and where u lands exactly on a CDF entry."""
    rng = np.random.default_rng(3)
    n, s, count = 64, 16, 48
    w = np.where(rng.uniform(size=(n, s)) < 0.7, 0.0, rng.uniform(size=(n, s)))
    pdf_w = torch.from_numpy(np.maximum(w[:, 1:-1], 0.0).astype(np.float32)) + 1e-5
    cdf = torch.cumsum(pdf_w / pdf_w.sum(-1, keepdim=True), -1)
    cdf = torch.cat([torch.zeros(n, 1), cdf[:, :-1], torch.ones(n, 1)], -1)
    u = torch.from_numpy(rng.uniform(size=(n, count)).astype(np.float32))
    u[:, :s - 2] = cdf[:, :s - 2]                       # exact CDF entries below 1
    j = torch.clamp(torch.searchsorted(cdf, u, right=True) - 1, 0, s - 3)
    one_hot = (u[..., :, None] >= cdf[..., None, :-1]) & (u[..., :, None] < cdf[..., None, 1:])
    assert bool((one_hot.sum(-1) == 1).all())
    np.testing.assert_array_equal(j.numpy(), one_hot.int().argmax(-1).numpy())


def test_merge_samples_match_jax():
    rng = np.random.default_rng(4)
    a = rng.uniform(2, 6, size=(6, 8)).astype(np.float32)
    b = rng.uniform(2, 6, size=(6, 16)).astype(np.float32)
    got = sampling.merge_samples(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_sampling.merge_samples(a, b)))


@pytest.mark.parametrize("white", [True, False])
def test_composite_matches_jax(white):
    rng = np.random.default_rng(5)
    c = rng.uniform(size=(9, 20, 3)).astype(np.float32)
    w = (rng.uniform(size=(9, 20)) / 20).astype(np.float32)
    got = volume.composite(torch.from_numpy(c), torch.from_numpy(w), white_background=white)
    want = jax_volume.composite(jnp.asarray(c), jnp.asarray(w), white_background=white)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
