"""Haar maxlet transform and breakpoint weights as batch JAX kernels.

The reference computes these with a streaming stack in one sequential pass
(reference: src/wavelet.hpp:98-188 and :68-93). Here the same quantities are
computed as log2(T) data-parallel levels of pairwise float32 ops, which
reproduces the streaming version's pairwise-dyadic summation order *exactly*
(bit-exact float32), because both perform the identical tree of adds.

Semantics:
- ``maxlet_transform(data)``: coeffs[t] = max over dims of
  (1/sqrt(2))^level * |sum_L - sum_R| for the unique Haar wavelet whose
  central discontinuity is at t (level = ctz(t)+1). Positions whose wavelet
  support is not fully contained in [0, T), and position 0, are +inf.
- ``breakpoint_weights(coeffs)``: w[t] = max |coeff| over all wavelets with
  any discontinuity (center or support edge) at t, via top-down dyadic
  max-propagation; trailing positions whose sibling lies beyond T are +inf.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

_SQRT2HALF = np.float32(np.float32(np.sqrt(np.float64(2.0))) / np.float32(2.0))


def _level_normalizers(n_levels: int) -> list[np.float32]:
    """(1/sqrt2)^level computed by repeated float32 multiplication, matching
    the reference's running `normalizer *= sqrt2half` (wavelet.hpp:172)."""
    norms = []
    norm = _SQRT2HALF
    for _ in range(n_levels):
        norms.append(norm)
        norm = np.float32(norm * _SQRT2HALF)
    return norms


@jax.jit
def maxlet_transform(data: jax.Array) -> jax.Array:
    """data: (T,) or (T, dim) float32 -> coeffs (T,) float32."""
    if data.ndim == 1:
        data = data[:, None]
    T = data.shape[0]
    coeffs = jnp.full((T,), jnp.inf, dtype=jnp.float32)
    n_levels = max(1, T.bit_length() - 1) if T > 0 else 0
    norms = _level_normalizers(n_levels + 1)
    sums = data.astype(jnp.float32)
    level = 1
    while sums.shape[0] >= 2:
        n_pairs = sums.shape[0] // 2
        left = sums[0 : 2 * n_pairs : 2]
        right = sums[1 : 2 * n_pairs : 2]
        detail = jnp.max(norms[level - 1] * jnp.abs(left - right), axis=1)
        # node a covers [a*2^l, (a+1)*2^l); after tail-dropping every kept
        # node is complete, and its coefficient index a*2^l + 2^(l-1) < T.
        # On-device iota, not np.arange: a host index array would embed
        # ~T int64 constants in the HLO over all levels.
        idx = (jax.lax.iota(jnp.int32, n_pairs) << level) + (1 << (level - 1))
        coeffs = coeffs.at[idx].set(detail)
        sums = left + right  # pairwise-dyadic float32 adds (exact ref order)
        level += 1
    coeffs = coeffs.at[0].set(jnp.inf)
    return coeffs


@jax.jit
def breakpoint_weights(coeffs: jax.Array) -> jax.Array:
    """coeffs: (T,) float32 maxlet transform -> breakpoint weights (T,).

    Top-down propagation: at each dyadic level (interval I, node centers at
    odd multiples of I), the node's coefficient is max-propagated onto both
    support edges (even multiples of I). All ops are exact max/compares, so
    the result is bit-identical to the reference's in-place loop.

    Implemented as a PYRAMID: level I only ever touches multiples of I, and
    the centers it reads (odd multiples of I) are untouched raw coefficients
    (coarser levels only write multiples of 2I) — so the carry is just the
    current values at multiples of 2I (a (p/2I,) array), interleaved with
    the raw centers after each level. A full-length formulation updated two
    (T,) arrays per level via scatters, which XLA kept live across all
    log2(T) levels (O(T log T) device memory); the pyramid peaks at ~4
    T-sized buffers.
    """
    T = coeffs.shape[0]
    p = 1
    while p < T:
        p *= 2
    cpad = jnp.pad(coeffs, (0, p - T))  # padded values are never selected
    A = cpad[:1]  # values at multiples of p (position 0)
    interval = p // 2
    while interval >= 1:
        I2 = 2 * interval
        m = cpad[interval::I2]  # raw centers: odd multiples of I, (p/I2,)
        nm = m.shape[0]  # == A.shape[0] == p // I2
        # masks via on-device iota: np.arange-derived masks embed (p/I2,)
        # CONSTANT LITERALS in the HLO — ~134 MB at T=250M, which the
        # compiler has to hold and fold
        kj = jax.lax.iota(jnp.int32, nm)
        center_pos = (2 * kj + 1) * jnp.int32(interval)  # < p <= 2^30: int32-safe
        # node exists iff its center is a data position; its right edge
        # (2k+2)*I must also lie inside [0, T) to propagate, else the node
        # and its left edge become inf (wavelet support incomplete)
        activej = center_pos < T
        cond = activej & (center_pos + jnp.int32(interval) < T)
        left_contrib = jnp.where(cond, m, -jnp.inf)
        force_inf = jnp.where(activej & ~cond, jnp.inf, -jnp.inf)
        newA = jnp.maximum(A, jnp.maximum(left_contrib, force_inf))
        # right edge of node k is edge k+1 (the last node's right edge is
        # p, outside the pyramid, and its cond is False by construction)
        right_shift = jnp.concatenate(
            [jnp.full((1,), -jnp.inf, A.dtype), jnp.where(cond, m, -jnp.inf)[: nm - 1]]
        )
        newA = jnp.maximum(newA, right_shift)
        new_m = jnp.where(cond | ~activej, m, jnp.inf)
        # interleave: position 2j*I = newA[j], (2j+1)*I = new_m[j].
        # Gather + parity select keeps every array 1-D (no (n, 2) stack-
        # reshape with a size-2 minor dimension).
        n2 = 2 * nm
        j = jax.lax.iota(jnp.int32, n2) >> 1
        parity = (jax.lax.iota(jnp.int32, n2) & 1) == 1
        A = jnp.where(parity, new_m[j], newA[j])
        interval //= 2
    return A[:T]
