"""Matrix-product precision on the sweep's hot path.

A float32 product at the backend's default precision may run in TF32 on a
GPU (about 3 significant digits). The sweep statistics, the emission
log-weights and the forward combine carry sums of up to ~T values, so every
``dot_general`` they lower to must request HIGHEST precision. The check
reads the lowered StableHLO, which is the same on every backend, so it runs
on the CPU.
"""

import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from hammlet_tpu.models.distributions import (
    emission_log_weights,
    emission_log_weights_t,
)
from hammlet_tpu.samplers.forward_backward import _scaled_matmul
from hammlet_tpu.samplers.sweep import accumulate_sweep_stats

_DOT = re.compile(r"stablehlo\.dot_general.*?precision = \[(\w+), (\w+)\]")

K, B, DIM = 3, 256, 2
MAPPING = np.array([[0, 1], [1, 2], [2, 0]], np.int32)


def _dot_precisions(hlo_text: str) -> list[tuple[str, str]]:
    n_dots = hlo_text.count("stablehlo.dot_general")
    found = _DOT.findall(hlo_text)
    assert len(found) == n_dots, "dot_general without a precision attribute"
    return found


def _accumulate():
    rng = np.random.default_rng(0)
    args = (
        jnp.asarray(rng.integers(0, K, B), jnp.int32),
        jnp.asarray(rng.integers(1, 50, B), jnp.int32),
        jnp.int32(B - 7),
        jnp.asarray(rng.normal(size=(DIM, 2, B)), jnp.float32),
        jnp.asarray(MAPPING),
    )
    return jax.jit(accumulate_sweep_stats, static_argnums=5).lower(*args, 3)


def _emission(fn, stats_shape):
    def lower():
        rng = np.random.default_rng(1)
        args = (
            jnp.asarray(rng.normal(size=stats_shape), jnp.float32),
            jnp.asarray(rng.integers(1, 50, B), jnp.int32),
            jnp.asarray(rng.normal(size=3), jnp.float32),
            jnp.asarray(rng.uniform(0.5, 2.0, size=3), jnp.float32),
            jnp.asarray(MAPPING),
        )
        return jax.jit(fn).lower(*args)

    return lower


def _scaled():
    x = jnp.ones((8, K, K), jnp.float32)
    return jax.jit(_scaled_matmul).lower(x, x)


def _sharded_phase():
    from hammlet_tpu.parallel import make_sharded_engine, position_mesh

    data = np.random.default_rng(2).normal(0, 1, 4000).astype(np.float32)
    eng = make_sharded_engine(data, mesh=position_mesh(2), nr_params=3, seed=1)
    fn = eng._phase_fn("F", 2, 0, record=False)
    candpos, candrank = eng._shard_candidates()
    return fn.lower(
        eng._key, eng.model, eng.priors, eng.negw, candpos, candrank, eng.r,
        eng.q2_hi, eng.q2_lo, eng.counts, eng.everb, eng.n_rec, eng.n_bound,
        np.int32(1), np.bool_(True), np.float32(0.0),
    )


def _single_phase():
    from hammlet_tpu.runner import make_engine
    from hammlet_tpu.samplers.sweep import gibbs_phase

    data = np.random.default_rng(3).normal(0, 1, 4000).astype(np.float32)
    eng = make_engine(data, nr_params=3, seed=1)
    cand_pos, cand_rank = eng._candidates()
    return gibbs_phase.lower(
        eng._key, eng.model, eng.priors, eng.ing.ranked, cand_pos, cand_rank,
        eng.ing.prefix, eng.buffers, np.int32(1), np.bool_(True),
        np.float32(0.0), method="F", capacity=eng.capacity,
        spec_nr_params=3, mapping_tuple=eng._mapping_tuple,
        use_self_transitions=True, n_iters=2, thinning=1,
        cell_bits=eng.ing.cell_bits, record=True,
    )


@pytest.mark.parametrize(
    "lower",
    [
        _accumulate,
        _emission(emission_log_weights_t, (DIM, 2, B)),
        _emission(emission_log_weights, (B, DIM, 2)),
        _scaled,
        _sharded_phase,
        _single_phase,
    ],
    ids=[
        "accumulate_sweep_stats", "emission_log_weights_t",
        "emission_log_weights", "scaled_matmul", "sharded_phase",
        "single_device_phase",
    ],
)
def test_every_dot_is_highest_precision(lower):
    precisions = _dot_precisions(lower().as_text())
    assert precisions, "expected at least one dot_general in the program"
    assert all(p == ("HIGHEST", "HIGHEST") for p in precisions), precisions


@pytest.mark.gpu
def test_emission_log_weights_on_gpu_match_float64(gpu_device):
    """On the card, a 10^5-position block's log-weight must match a float64
    recomputation far inside one nat (TF32 inputs miss by tens of nats)."""
    rng = np.random.default_rng(4)
    n = rng.integers(50_000, 150_000, B)
    mu = rng.normal(0, 2, (B, DIM))
    sums = n[:, None] * mu
    sumsqs = n[:, None] * (mu * mu + 1.0)
    stats_t = np.stack([sums.T, sumsqs.T], axis=1).astype(np.float32)
    theta_mean = np.array([0.0, 2.0, -2.0], np.float32)
    theta_var = np.array([1.0, 1.2, 0.8], np.float32)
    with jax.default_device(gpu_device):
        got = np.asarray(jax.jit(emission_log_weights_t)(
            jnp.asarray(stats_t), jnp.asarray(n, jnp.int32),
            jnp.asarray(theta_mean), jnp.asarray(theta_var),
            jnp.asarray(MAPPING),
        ))
    a = (theta_mean / theta_var).astype(np.float64)
    b = (0.5 / theta_var).astype(np.float64)
    c = 0.5 * np.log(theta_var.astype(np.float64)) + theta_mean**2 * b
    m = MAPPING
    s64 = stats_t.astype(np.float64)
    want = (
        np.einsum("kd,db->kb", a[m], s64[:, 0]) -
        np.einsum("kd,db->kb", b[m], s64[:, 1]) -
        c[m].sum(axis=1)[:, None] * n[None, :]
    )
    scale = np.abs(s64[:, 1]).sum(axis=0) / (2 * theta_var.min())
    assert np.all(np.abs(got - want) <= 1e-5 * scale + 1e-3)
