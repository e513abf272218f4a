"""Runtime invariant checks (debug mode).

The reference guards its numerics with runtime_error throws: finiteness/
positivity on every parameter setter (Observation.hpp:374-392), negative
backward variables (ForwardBackward.hpp:147-149), and the marginal-sum
invariant at save (StateMarginals.hpp:306-308). Inside jitted device
programs a NaN would otherwise propagate silently into wrong marginals.

Equivalent here:
- HAMMLET_DEBUG=1 (default ON under pytest via tests/conftest.py) compiles
  an error bitmask into every sweep: non-finite/non-positive resampled
  parameters and non-finite block statistics are OR-reduced across each
  scanned chunk and surfaced through the chunk's single host sync, where
  the driver raises. The flag is STATIC, so production programs compile
  without any of these reductions.
- the marginal-sum invariant (every segment's counts sum to the number of
  recorded sweeps) is checked unconditionally at save time, like the
  reference.
"""

from __future__ import annotations

import os

import jax.numpy as jnp

ERR_THETA_MEAN = 1  # non-finite resampled emission mean
ERR_THETA_VAR = 2  # non-finite or non-positive resampled emission variance
ERR_TRANS = 4  # non-finite transition/initial probabilities
ERR_BLOCK_STATS = 8  # non-finite block sufficient statistics

_NAMES = {
    ERR_THETA_MEAN: "non-finite emission mean",
    ERR_THETA_VAR: "non-positive emission variance",
    ERR_TRANS: "non-finite transition/initial distribution",
    ERR_BLOCK_STATS: "non-finite block statistics",
}


def debug_enabled() -> bool:
    return os.environ.get("HAMMLET_DEBUG", "0") == "1"


def model_error_bits(model, bstats=None):
    """() int32 bitmask of violated invariants (0 = all good)."""
    err = jnp.int32(0)
    err += jnp.where(
        jnp.all(jnp.isfinite(model.theta_mean)), 0, ERR_THETA_MEAN
    )
    err += jnp.where(
        jnp.all(jnp.isfinite(model.theta_var) & (model.theta_var > 0)),
        0, ERR_THETA_VAR,
    )
    err += jnp.where(
        jnp.all(jnp.isfinite(model.A)) & jnp.all(jnp.isfinite(model.pi)),
        0, ERR_TRANS,
    )
    if bstats is not None:
        err += jnp.where(jnp.all(jnp.isfinite(bstats)), 0, ERR_BLOCK_STATS)
    return err


def raise_on_error(err: int) -> None:
    """Decode a sweep error bitmask into the loud failure the reference
    would have thrown (Observation.hpp:374-392 etc.)."""
    if not err:
        return
    what = [name for bit, name in _NAMES.items() if err & bit]
    raise FloatingPointError(
        "invariant violation during Gibbs sweep: " + "; ".join(what)
        + " (HAMMLET_DEBUG=1)"
    )


def check_marginal_sums(seg_counts, n_records: int) -> None:
    """The reference's save-time invariant: every marginal row's counts sum
    to the number of recorded sweeps (StateMarginals.hpp:306-308)."""
    import numpy as np

    sums = np.asarray(seg_counts).sum(axis=1)
    if len(sums) and not (sums == int(n_records)).all():
        bad = int((sums != int(n_records)).sum())
        raise RuntimeError(
            f"Number of counts ({int(sums[0])} at the first of {bad} bad "
            f"segments) does not match number of iterations "
            f"({int(n_records)})!"
        )
