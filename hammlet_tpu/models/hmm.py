"""Model-state pytrees for the wavelet-compressed Bayesian HMM.

Gathers what the reference spreads over Theta/Transitions/Initial plus their
hyper-parameter objects (src/Theta.hpp, src/Transitions.hpp, src/Initial.hpp,
src/*HyperParam.hpp) into two flat pytrees that flow through the jitted sweep.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from hammlet_tpu.models.mapping import combinations_mapping
from hammlet_tpu.models import distributions as dist


class ModelSpec(NamedTuple):
    """Static model configuration (hashable; closed over by jit)."""

    nr_params: int
    nr_data_dim: int
    use_self_transitions: bool = True

    @property
    def nr_states(self) -> int:
        return self.nr_params**self.nr_data_dim

    def mapping(self) -> np.ndarray:
        return combinations_mapping(self.nr_data_dim, self.nr_params)


class HMMPriors(NamedTuple):
    """Prior hyper-parameters (constants of a run).

    nig:       (P, 4) float32 — (alpha, beta, mu0, nu) per emission parameter
    a_alphas:  (K, K) float32 — Dirichlet alphas per transition row
               (off-diagonal = -t value 1, diagonal = value 2; main.cpp:146-155)
    pi_alphas: (K,) float32   — Dirichlet alphas of the initial distribution
    """

    nig: jax.Array
    a_alphas: jax.Array
    pi_alphas: jax.Array

    @staticmethod
    def create(
        nig: np.ndarray,
        nr_states: int,
        trans: float = 0.5,
        self_trans: float = 0.5,
        initial_alpha: float = 0.5,
    ) -> "HMMPriors":
        a = np.full((nr_states, nr_states), trans, dtype=np.float32)
        np.fill_diagonal(a, self_trans)
        return HMMPriors(
            nig=jnp.asarray(nig, dtype=jnp.float32),
            a_alphas=jnp.asarray(a),
            pi_alphas=jnp.full((nr_states,), initial_alpha, dtype=jnp.float32),
        )


class HMMState(NamedTuple):
    """Sampled model state (one Gibbs iterate).

    theta_mean/theta_var: (P,) emission Normal parameters
    A:  (K, K) transition matrix
    pi: (K,) initial state distribution
    """

    theta_mean: jax.Array
    theta_var: jax.Array
    A: jax.Array
    pi: jax.Array

    def threshold(self, T: int) -> jax.Array:
        """Compression threshold sqrt(2 ln T * min variance)
        (BreakpointArray.hpp:196-199, Theta.hpp:227-244). Host callers use
        ``threshold_host`` below — the two must stay in lockstep (pinned by
        tests/test_samplers.py::test_threshold_host_matches_device)."""
        return jnp.sqrt(
            2.0 * jnp.log(jnp.float32(T)) * jnp.min(self.theta_var)
        ).astype(jnp.float32)


def threshold_host(theta_var, T: int) -> float:
    """Host-side compression threshold — the same formula as
    HMMState.threshold, evaluated in float64 numpy without a device
    dispatch and sync. Single shared implementation for the
    engines' capacity sizing (runner/sharded previously each re-derived
    it inline)."""
    with np.errstate(invalid="ignore"):  # poisoned models produce NaN, the
        # debug error-bit path reports them; don't warn here as well
        return float(
            np.sqrt(
                2.0
                * np.log(max(2.0, float(T)))
                * float(np.asarray(theta_var).min())
            )
        )


@jax.jit
def sample_from_priors(key: jax.Array, priors: HMMPriors) -> HMMState:
    """Draw a full model state from the prior (the reference's 'P' token /
    initial sampling, main.cpp:397-400)."""
    k_theta, k_a, k_pi = jax.random.split(key, 3)
    mean, var = dist.nig_sample(k_theta, priors.nig)
    A = dist.dirichlet_sample(k_a, priors.a_alphas)
    pi = dist.dirichlet_sample(k_pi, priors.pi_alphas)
    return HMMState(mean, var, A, pi)


class SweepStats(NamedTuple):
    """Aggregated per-sweep observation statistics (the reference's pass 3,
    ForwardBackward.hpp:170-212)."""

    theta_sums: jax.Array  # (P,)
    theta_sumsqs: jax.Array  # (P,)
    theta_counts: jax.Array  # (P,)
    trans_counts: jax.Array  # (K, K)
    state_counts: jax.Array  # (K,)


def resample_model(
    key: jax.Array, priors: HMMPriors, stats: SweepStats
) -> HMMState:
    """Conjugate posterior draws for theta, A, pi given sweep statistics
    (HMM.hpp:111-115: theta.sample, pi.sample, A.sample with posterior
    reset).

    All Gamma variates (InvGamma for theta variances, Dirichlet rows for A
    and pi) are drawn in ONE fixed-depth gamma call — a data-dependent
    rejection loop per variate family would be the latency hot spot of the
    model update."""
    k_gamma, k_normal = jax.random.split(key)
    nig_post = dist.nig_update(
        priors.nig, stats.theta_sums, stats.theta_sumsqs, stats.theta_counts
    )
    P = nig_post.shape[0]
    K = priors.pi_alphas.shape[0]
    a_post = priors.a_alphas + stats.trans_counts
    pi_post = priors.pi_alphas + stats.state_counts
    alphas = jnp.concatenate(
        [nig_post[:, 0], a_post.reshape(-1), pi_post]
    )
    g = dist.gamma_fixed_tries(k_gamma, alphas)
    var = nig_post[:, 1] / g[:P]
    A_g = g[P : P + K * K].reshape(K, K)
    A = A_g / jnp.sum(A_g, axis=1, keepdims=True)
    pi_g = g[P + K * K :]
    pi = pi_g / jnp.sum(pi_g)
    mean = nig_post[:, 2] + jnp.sqrt(var / nig_post[:, 3]) * jax.random.normal(
        k_normal, (P,)
    )
    return HMMState(mean, var, A, pi)
