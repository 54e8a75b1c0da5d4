"""tracer_torch.core.rng against tracer.core.rng: the hash streams are
bit-equal; the samplers agree to float32 rounding of their libm calls."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracer.core import rng as jax_rng
from tracer_torch.core import rng

sys.path.insert(0, os.path.dirname(__file__))
from torch_scenes import one_torch_thread  # noqa: E402,F401

EDGE_SEEDS = np.array([0, 1, 61, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1], np.uint32)


def _seeds(n=1_000_000):
    s = np.random.default_rng(0).integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    s[: EDGE_SEEDS.size] = EDGE_SEEDS
    return s


def _t(seeds_u32):
    return torch.from_numpy(seeds_u32.astype(np.int64))


def test_wang_hash_bit_equal_on_a_million_seeds():
    s = _seeds()
    want = np.asarray(jax_rng.wang_hash(jnp.asarray(s)))
    got = rng.wang_hash(_t(s)).numpy()
    assert got.min() >= 0 and got.max() < 2**32
    np.testing.assert_array_equal(got.astype(np.uint32), want)


def test_random_float_bit_equal_on_a_million_seeds():
    s = _seeds()
    want_seed, want_u = (np.asarray(x) for x in jax_rng.random_float(jnp.asarray(s)))
    got_seed, got_u = rng.random_float(_t(s))
    np.testing.assert_array_equal(got_seed.numpy().astype(np.uint32), want_seed)
    assert got_u.dtype == torch.float32
    np.testing.assert_array_equal(got_u.numpy(), want_u)  # bit-equal floats
    assert got_u.max().item() <= 1.0  # values near 2^32 round up to exactly 1.0


def test_random_float_single_rounding_near_two_pow_32():
    # the largest uint32 rounds to 2^32 in one rounding: u == 1.0 exactly
    seed = torch.tensor([2**32 - 1], dtype=torch.int64)
    assert (seed.to(torch.float32) * (1.0 / 4294967296.0)).item() == 1.0


SAMPLERS = ["unit_vector", "in_unit_sphere", "in_hemisphere"]


@pytest.mark.parametrize("name", SAMPLERS)
def test_samplers_match(name):
    s = _seeds(200_000)
    normal = np.random.default_rng(1).normal(size=(s.size, 3)).astype(np.float32)
    if name == "in_hemisphere":
        want = jax_rng.random_in_hemisphere(jnp.asarray(normal), jnp.asarray(s))
        got = rng.random_in_hemisphere(torch.from_numpy(normal), _t(s))
    else:
        want = getattr(jax_rng, f"random_{name}")(jnp.asarray(s))
        got = getattr(rng, f"random_{name}")(_t(s))
    np.testing.assert_array_equal(got[0].numpy().astype(np.uint32), np.asarray(want[0]))
    # cos/sin/cbrt differ between libm implementations in the last places
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=1e-6)


@pytest.mark.parametrize("quirk", [True, False])
@pytest.mark.parametrize("width, height", [(32, 8), (7, 5), (1080, 720)])
def test_pixel_seed(quirk, width, height):
    jj, ii = np.meshgrid(np.arange(height, dtype=np.uint32), np.arange(width, dtype=np.uint32),
                         indexing="ij")
    want = np.asarray(jax_rng.pixel_seed(jnp.asarray(ii.ravel()), jnp.asarray(jj.ravel()),
                                         width, reference_quirk=quirk))
    got = rng.pixel_seed(torch.from_numpy(ii.ravel().astype(np.int64)),
                         torch.from_numpy(jj.ravel().astype(np.int64)), width,
                         reference_quirk=quirk)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


@pytest.mark.parametrize("s", [0, 1, 7, 2**31, 2**32 - 1])
def test_sample_seed_wraps_uint32(s):
    base = _seeds(4096)
    want = np.asarray(jax_rng.sample_seed(jnp.asarray(base), jnp.uint32(s)))
    got = rng.sample_seed(_t(base), s)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
