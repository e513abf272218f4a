"""Conjugate updates and posterior draws as pure JAX functions.

Replaces the reference's Conjugate/Distribution/Theta/Transitions/Initial
object graph (src/Conjugate.hpp, src/Distribution.hpp, src/Theta.hpp,
src/Transitions.hpp, src/Initial.hpp) with vectorized functional updates on
parameter arrays, driven by counter-based ``jax.random`` keys. RNG-stream
parity with the reference's single mt19937 is a non-goal (BASELINE.json);
the draws are from the identical distributions.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

#: the emission products below carry sums of up to ~10^5-10^8 values per
#: block, and ip = a * sum_x - b * sum_x2 cancels two large terms: TF32
#: input rounding (~5e-4 relative, what a GPU may use at default
#: precision) would be an error of tens of nats, so they pin full float32
_HIGHEST = jax.lax.Precision.HIGHEST


def nig_update(prior: jax.Array, sums: jax.Array, sumsqs: jax.Array, counts: jax.Array) -> jax.Array:
    """Batch Normal-Inverse-Gamma conjugate update.

    prior:  (P, 4) float32 rows (alpha, beta, mu0, nu)
    sums/sumsqs/counts: (P,) aggregated observation statistics per parameter
    Returns the (P, 4) posterior. Parameters with zero observations keep the
    prior. Mirrors Conjugate.hpp:120-168 including the guard clamping the
    naive (sum^2/N) term at sumSq to avoid negative sample variance.
    """
    alpha, beta, mu0, nu = prior[:, 0], prior[:, 1], prior[:, 2], prior[:, 3]
    n = counts.astype(jnp.float32)
    safe_n = jnp.maximum(n, 1.0)
    xbar = sums / safe_n
    ssn = jnp.minimum((sums * sums) / safe_n, sumsqs)
    new_alpha = alpha + n / 2.0
    new_beta = beta + (
        (sumsqs + (n * nu / (n + nu)) * (xbar - mu0) ** 2) - ssn
    ) / 2.0
    new_mu0 = (nu * mu0 + sums) / (nu + n)
    new_nu = nu + n
    post = jnp.stack([new_alpha, new_beta, new_mu0, new_nu], axis=1)
    return jnp.where((counts > 0)[:, None], post, prior)


def nig_sample(key: jax.Array, params: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Draw (mean, var) per parameter from NIG rows (alpha, beta, mu0, nu).

    var ~ InvGamma(alpha, beta) = beta / Gamma(alpha, 1);
    mean ~ Normal(mu0, sqrt(var / nu)).  (Distribution.hpp:76-87)
    """
    kg, kn = jax.random.split(key)
    alpha, beta, mu0, nu = params[:, 0], params[:, 1], params[:, 2], params[:, 3]
    g = jax.random.gamma(kg, alpha)
    var = beta / g
    mean = mu0 + jnp.sqrt(var / nu) * jax.random.normal(kn, alpha.shape)
    return mean, var


def gamma_fixed_tries(
    key: jax.Array, alphas: jax.Array, tries: int = 8
) -> jax.Array:
    """Gamma(alpha, 1) draws with a FIXED-depth Marsaglia-Tsang rejection
    sampler (no lax.while_loop).

    ``jax.random.gamma``'s rejection loop is a sequential while_loop whose
    latency dominated the per-sweep conjugate model update (a data-dependent
    loop serializes ~15 tiny variates into many dependent device steps).
    Marsaglia-Tsang squeeze acceptance is >= 0.95 per try for alpha >= 1, so ``tries`` independent proposals leave a < 1e-10
    probability of total rejection; the (then unbiased-to-float-precision)
    fallback is the distribution mode. alpha < 1 uses the standard
    alpha+1 boost: G(a) = G(a+1) * U^(1/a).
    """
    a = jnp.asarray(alphas, jnp.float32)
    shape = a.shape
    boost_needed = a < 1.0
    a_eff = jnp.where(boost_needed, a + 1.0, a)

    d = a_eff - 1.0 / 3.0
    c = 1.0 / jnp.sqrt(9.0 * d)

    k_n, k_u, k_b = jax.random.split(key, 3)
    x = jax.random.normal(k_n, (tries,) + shape, dtype=jnp.float32)
    u = jax.random.uniform(
        k_u, (tries,) + shape, dtype=jnp.float32, minval=1e-38
    )
    t = c * x
    v = (1.0 + t) ** 3
    # acceptance statistic 0.5 x^2 + d (1 - v + log v). Expanding in t = c x
    # with v = (1+t)^3 gives d * (3 (log1p(t) - t) - 3 t^2 - t^3); every term
    # is O(x^2) because d t^2 = x^2/9, so it stays accurate in float32 at
    # posterior alphas ~1e7+ where the naive d - d v + d log v form loses all
    # significance (ulp(d v) ~ 1 while the residual is O(1)). log1p(t) - t
    # itself cancels for small |t|, so it switches to its Taylor series there.
    series = -(t * t) * (
        1.0 / 2.0
        - t * (1.0 / 3.0 - t * (1.0 / 4.0 - t * (1.0 / 5.0
            - t * (1.0 / 6.0 - t * (1.0 / 7.0 - t / 8.0)))))
    )
    log1p_m_t = jnp.where(
        jnp.abs(t) < 0.1, series, jnp.log1p(jnp.maximum(t, -0.999999)) - t
    )
    accept_stat = 0.5 * x * x + d * (3.0 * log1p_m_t - t * t * (3.0 + t))
    ok = (v > 0.0) & (jnp.log(u) < accept_stat)
    cand = d * jnp.maximum(v, 0.0)
    # first accepted proposal; fall back to the mode (= d) if all rejected
    first = jnp.argmax(ok, axis=0)
    any_ok = jnp.any(ok, axis=0)
    g = jnp.where(any_ok, jnp.take_along_axis(cand, first[None], axis=0)[0], d)
    # boost for alpha < 1
    ub = jax.random.uniform(k_b, shape, dtype=jnp.float32, minval=1e-38)
    g = jnp.where(boost_needed, g * ub ** (1.0 / jnp.maximum(a, 1e-6)), g)
    return g


def dirichlet_sample(key: jax.Array, alphas: jax.Array) -> jax.Array:
    """Dirichlet draw(s) via normalized Gammas (Distribution.hpp:116-139).
    alphas: (..., K); normalizes over the last axis."""
    g = jax.random.gamma(key, alphas)
    return g / jnp.sum(g, axis=-1, keepdims=True)


def emission_log_weights(
    block_stats: jax.Array,
    sizes: jax.Array,
    theta_mean: jax.Array,
    theta_var: jax.Array,
    mapping: jax.Array,
) -> jax.Array:
    """Per-(block, state) log emission weight E (without self-transitions).

    E_b(s) = sum_d [ (2 mu sum_x - sum_x2) / (2 var) ]_{p = mapping[s,d]}
             - N_b * sum_d logNormalizer(p)
    (EFD.hpp:23-38, ForwardBackward.hpp:75)

    block_stats: (B, dim, 2); sizes: (B,); theta_*: (P,); mapping: (K, dim)
    Returns (B, K) float32.
    """
    a = theta_mean / theta_var  # per param: mu / var
    b = 0.5 / theta_var  # per param: 1 / (2 var)
    c = 0.5 * jnp.log(theta_var) + theta_mean**2 * b  # log sigma + mu^2/(2 var)
    A = a[mapping]  # (K, dim)
    Bc = b[mapping]
    C = jnp.sum(c[mapping], axis=1)  # (K,)
    sums = block_stats[..., 0]  # (B, dim)
    sumsqs = block_stats[..., 1]
    ip = jnp.dot(sums, A.T, precision=_HIGHEST) - jnp.dot(
        sumsqs, Bc.T, precision=_HIGHEST
    )  # (B, K)
    return ip - sizes.astype(jnp.float32)[:, None] * C[None, :]


def emission_log_weights_t(
    block_stats_t: jax.Array,
    sizes: jax.Array,
    theta_mean: jax.Array,
    theta_var: jax.Array,
    mapping: jax.Array,
) -> jax.Array:
    """emission_log_weights in transposed layout: block_stats_t is
    (dim, 2, B) (ops.blocks.block_sufficient_stats_t) and the result is
    (K, B) — block axis minor everywhere, so the long axis is the
    contiguous one and no small K or dim axis is strided over."""
    a = theta_mean / theta_var
    b = 0.5 / theta_var
    c = 0.5 * jnp.log(theta_var) + theta_mean**2 * b
    A = a[mapping]  # (K, dim)
    Bc = b[mapping]
    C = jnp.sum(c[mapping], axis=1)  # (K,)
    sums_t = block_stats_t[:, 0, :]  # (dim, B)
    sumsqs_t = block_stats_t[:, 1, :]
    ip = jnp.einsum(
        "kd,db->kb", A, sums_t,
        preferred_element_type=jnp.float32, precision=_HIGHEST,
    ) - jnp.einsum(
        "kd,db->kb", Bc, sumsqs_t,
        preferred_element_type=jnp.float32, precision=_HIGHEST,
    )
    return ip - C[:, None] * sizes.astype(jnp.float32)[None, :]


# -- Beta / Geometric family -------------------------------------------------
# The reference carries a Geometric-emission/Beta-conjugate family in its
# probability kernel (SufficientStatistics.hpp:310-388, Conjugate.hpp:209-215,
# Distribution.hpp:94-107, EFD.hpp:64-77, Theta.hpp:248-257) although main.cpp
# only wires the Normal family; provided here for the same capability surface.


def beta_update(prior: jax.Array, sums: jax.Array, counts: jax.Array) -> jax.Array:
    """Beta conjugate update for Geometric observations: rows (alpha, beta);
    alpha += N, beta += sum (Conjugate.hpp:209-215)."""
    return jnp.stack(
        [prior[:, 0] + counts.astype(jnp.float32), prior[:, 1] + sums], axis=1
    )


def beta_sample(key: jax.Array, params: jax.Array) -> jax.Array:
    """Beta draws via two Gammas (Distribution.hpp:94-107)."""
    ka, kb = jax.random.split(key)
    a = jax.random.gamma(ka, params[:, 0])
    b = jax.random.gamma(kb, params[:, 1])
    return a / (a + b)


def geometric_log_weights(
    sums: jax.Array, sizes: jax.Array, theta_value: jax.Array
) -> jax.Array:
    """Per-(block, param) Geometric log emission weight:
    innerProduct = sum * value, logNormalizer = log(value)
    (EFD.hpp:64-77)."""
    return (
        sums[:, None] * theta_value[None, :]
        - sizes.astype(jnp.float32)[:, None] * jnp.log(theta_value)[None, :]
    )


def beta_threshold_value(theta_value: jax.Array) -> jax.Array:
    """Compression threshold statistic for Beta emissions: min over params of
    (1 - p) / p^2 (Theta.hpp:248-257)."""
    return jnp.min((1.0 - theta_value) / (theta_value * theta_value))
