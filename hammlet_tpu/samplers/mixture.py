"""Mixture (burn-in) state sampling: per-block independent categorical draws.

Replaces src/StateSequence/Mixture.hpp:31-144. Transitions and the initial
distribution are ignored; each block's state is drawn from the softmax of its
emission log-weights via the Gumbel-max trick — one fully parallel pass.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def mixture_sample_states(
    key: jax.Array,
    block_stats_t: jax.Array,  # (dim, 2, B) — ops.blocks.block_sufficient_stats_t
    sizes: jax.Array,
    n_blocks: jax.Array,
    theta_mean: jax.Array,
    theta_var: jax.Array,
    mapping: jax.Array,
) -> jax.Array:
    """(B,) int32 per-block states (padded blocks get state 0; mask later).

    Runs in transposed (K, B) layout (block axis minor and contiguous)."""
    from hammlet_tpu.models.distributions import emission_log_weights_t

    log_e_t = emission_log_weights_t(
        block_stats_t, sizes, theta_mean, theta_var, mapping
    )
    K, B = log_e_t.shape
    gumbel = jax.random.gumbel(key, (K, B), dtype=jnp.float32)
    states = jnp.argmax(log_e_t + gumbel, axis=0).astype(jnp.int32)
    return jnp.where(jnp.arange(B) < n_blocks, states, 0)
