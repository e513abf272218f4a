"""Bit-exactness of the JAX wavelet kernels against the golden NumPy model."""

import numpy as np
import jax.numpy as jnp
import pytest

from hammlet_tpu.golden import reference as gold
from hammlet_tpu.ops.wavelet import breakpoint_weights, maxlet_transform

SIZES = [2, 3, 4, 5, 7, 8, 15, 16, 17, 100, 255, 256, 1000, 4096, 10000]
#: sizes spanning many 2^13-position chunks, some with a ragged tail
LARGE_SIZES = [8192, 8193, 20000, 65536, 100000]


@pytest.mark.parametrize("T", SIZES + LARGE_SIZES)
def test_maxlet_bitexact_univariate(T):
    rng = np.random.default_rng(T)
    data = rng.normal(0, 1, size=(T, 1)).astype(np.float32) * 10
    want = gold.maxlet_transform(data)
    got = np.asarray(maxlet_transform(jnp.asarray(data)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("T", [4, 7, 64, 100, 1000, 30000])
@pytest.mark.parametrize("dim", [2, 3])
def test_maxlet_bitexact_multivariate(T, dim):
    rng = np.random.default_rng(T * 31 + dim)
    data = rng.normal(2, 3, size=(T, dim)).astype(np.float32)
    want = gold.maxlet_transform(data)
    got = np.asarray(maxlet_transform(jnp.asarray(data)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("T", SIZES)
def test_breakpoint_weights_bitexact(T):
    rng = np.random.default_rng(T + 999)
    data = rng.normal(0, 1, size=(T, 1)).astype(np.float32)
    coeffs = gold.maxlet_transform(data)
    want = gold.breakpoint_weights(coeffs)
    got = np.asarray(breakpoint_weights(jnp.asarray(coeffs)))
    np.testing.assert_array_equal(got, want)


def test_maxlet_structure():
    """coeffs[t] lives at the wavelet centered at t; incomplete supports and
    position 0 are +inf."""
    T = 12
    data = np.arange(T, dtype=np.float32)[:, None]
    c = np.asarray(maxlet_transform(jnp.asarray(data)))
    assert np.isinf(c[0])
    assert np.isinf(c[8])  # level-4 wavelet [0,16) incomplete for T=12
    finite = np.isfinite(c)
    # all level-1 odd positions are complete
    assert finite[1::2].all()


def test_weights_monotone_threshold_blocks():
    """Higher thresholds produce coarser partitions (nested boundaries)."""
    rng = np.random.default_rng(7)
    data = rng.normal(0, 1, size=(512, 1)).astype(np.float32)
    w = gold.breakpoint_weights(gold.maxlet_transform(data))
    starts_lo = set(gold.block_starts(w, 0.5).tolist())
    starts_hi = set(gold.block_starts(w, 3.0).tolist())
    assert starts_hi <= starts_lo


def test_ingest_device_matches_host_ingest():
    """The device ingest (XLA transform, weights, argsort ranking, in-cell
    prefix sums) against the host ingest on a T spanning several prefix
    cells: weights and ranking bit-identical, noise and prefix close."""
    from hammlet_tpu.ops.blocks import DEVICE_CELL_BITS
    from hammlet_tpu.runner import ingest, ingest_device

    T = 5 * (1 << DEVICE_CELL_BITS) + 1234
    rng = np.random.default_rng(11)
    mu = np.repeat(rng.choice([0.0, 2.0, -2.0], T // 500 + 1), 500)[:T]
    data = (mu + rng.normal(0, 1, T)).astype(np.float32)
    dev = ingest_device(data)
    host = ingest(data)
    np.testing.assert_array_equal(np.asarray(dev.weights), host.weights_host)
    np.testing.assert_array_equal(
        np.asarray(dev.ranked.pos_by_rank), np.asarray(host.ranked.pos_by_rank)
    )
    np.testing.assert_array_equal(
        np.asarray(dev.ranked.neg_w_sorted),
        np.asarray(host.ranked.neg_w_sorted),
    )
    np.testing.assert_allclose(dev.noise_std, host.noise_std, rtol=1e-6)
