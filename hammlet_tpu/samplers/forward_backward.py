"""Forward-Backward Gibbs state-sequence sampling as two associative scans.

The reference's sampler (src/StateSequence/ForwardBackward.hpp:16-213) is a
strictly sequential three-pass loop over blocks. This formulation keeps
the identical sampling distribution but exposes log-depth parallelism:

1. FORWARD. The filtering recursion
       alpha_b = normalize(alpha_{b-1} @ (A * e_b))
   is a product of per-block K x K matrices M_b = A * e_b[None, :]. Since a
   per-matrix positive rescaling cancels under the final normalization,
   cumulative products are computed with ``jax.lax.associative_scan`` using
   the combine (X, Y) -> (X @ Y) / max(X @ Y), giving alpha_b = pi @ P_b up
   to scale — batched K x K products with log(B) depth.

2. BACKWARD. Sequential backward sampling draws z_b ~ Cat(col_b * A[:, z_{b+1}]).
   Instead, for every block and every possible successor state j we draw an
   independent predecessor sample pred_b[j] via the Gumbel-max trick. Each
   pred_b is a random map [K] -> [K]; the sampled path is the composition
       z_b = (pred_b ∘ pred_{b+1} ∘ ... ∘ pred_{last-1})(z_last),
   and map composition is associative, so a reverse associative scan over
   the (B, K) map arrays yields every z_b in log depth. Because exactly one
   entry of each independent map is consumed, the joint law equals the
   sequential chain's.

Reference quirks reproduced for parity:
- the emission term includes (N-1) * log A_ss inside the forward recursion
  (ForwardBackward.hpp:77) AND the trellis column is retroactively scaled by
  exp((N-1) log A_ss) before backward sampling — for every block except the
  last (ForwardBackward.hpp:115-119);
- the last state is drawn from the *unscaled* final forward column
  (Trellis.hpp:61-66 via ForwardBackward.hpp:135).

Padding: blocks b >= n_blocks have size 0; their forward matrices are the
identity and their maps are the identity permutation, so they pass through
both scans without affecting the distribution.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _scaled_matmul(x: jax.Array, y: jax.Array) -> jax.Array:
    """Combine for the forward scan: batched (K,K) @ (K,K), rescaled by the
    max entry to stay in float32 range. Scale-invariant downstream.
    (Production runs the transposed Hillis-Steele form below; this combine
    is the oracle form used by the sharded cross-shard prefix and tests.)
    HIGHEST precision: at the default a GPU may round the operands to TF32."""
    z = jnp.einsum(
        "...ij,...jk->...ik", x, y,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    m = jnp.max(z, axis=(-2, -1), keepdims=True)
    return z / jnp.maximum(m, jnp.float32(1e-35))


def _compose_maps_rev(later: jax.Array, earlier: jax.Array) -> jax.Array:
    """Combine for the reverse backward scan. ``lax.associative_scan`` with
    ``reverse=True`` passes the element with the *higher* index first; the
    suffix composition r_b = m_b ∘ m_{b+1} ∘ ... therefore needs
    (later, earlier) -> earlier[later[j]] (apply the later map first)."""
    return jnp.take_along_axis(earlier, later, axis=-1)


#: group size for the two-level blocked scans: 7 in-group Hillis-Steele
#: levels, then one cross-group scan over B/128 totals — ~8B combines in
#: all vs the flat form's B·log2(B). The block capacity ladder only
#: produces multiples of 128, so every grouped reshape is exact. (A
#: Brent-Kung pair recursion needs (K, K, B/2, 2) intermediates with a
#: size-2 minor dimension; the grouped form keeps the long axis minor.)
#: Whether another group size is faster on the H100 is not measured yet.
_GROUP = 128


def _hs_prefix_matmul_t(Mt: jax.Array) -> jax.Array:
    """Hillis-Steele inclusive prefix products over the minor axis of a
    (K, K, B) stack (base case / cross-group totals): log2(B) levels of
    shift + batched combines, identity-padded on the left."""
    K = Mt.shape[0]
    B = Mt.shape[-1]
    eye = jnp.eye(K, dtype=Mt.dtype)[:, :, None]
    x = Mt
    d = 1
    while d < B:
        pad = jnp.broadcast_to(eye, (K, K, d))
        shifted = jnp.concatenate([pad, x[:, :, :-d]], axis=2)
        # z[i,k,b] = sum_j shifted[i,j,b] * x[j,k,b]  (earlier @ later):
        # an elementwise multiply and a K-term sum, not a dot, so it runs
        # in plain float32 whatever the matmul precision (no TF32 path)
        z = jnp.sum(shifted[:, :, None, :] * x[None, :, :, :], axis=1)
        m = jnp.max(z, axis=(0, 1), keepdims=True)
        x = z / jnp.maximum(m, jnp.float32(1e-35))
        d <<= 1
    return x


def prefix_matmul_scan_t(Mt: jax.Array) -> jax.Array:
    """Inclusive prefix products of B K x K matrices in TRANSPOSED layout
    (K, K, B) — the block axis minor, so every level's shift and combine
    runs over long contiguous rows instead of K x K tiles of 9 values.

    Two-level blocked form when B is a multiple of the group size:
    Hillis-Steele within (K, K, G, 128) contiguous groups (7 levels), a
    cross-group scan over the (K, K, G) group totals, then one broadcast
    combine — ~8B combines total vs B·log2(B) (15 levels of full-array
    traffic at the settled capacity ~30k) for the flat form."""
    K = Mt.shape[0]
    B = Mt.shape[-1]
    if B <= 2 * _GROUP or (B % _GROUP):
        return _hs_prefix_matmul_t(Mt)
    G = B // _GROUP
    x = Mt.reshape(K, K, G, _GROUP)
    eye4 = jnp.eye(K, dtype=Mt.dtype)[:, :, None, None]
    d = 1
    while d < _GROUP:  # in-group inclusive prefixes
        pad = jnp.broadcast_to(eye4, (K, K, G, d))
        shifted = jnp.concatenate([pad, x[..., :-d]], axis=-1)
        z = jnp.sum(shifted[:, :, None] * x[None], axis=1)
        m = jnp.max(z, axis=(0, 1), keepdims=True)
        x = z / jnp.maximum(m, jnp.float32(1e-35))
        d <<= 1
    totals = x[..., -1]  # (K, K, G) whole-group products
    pre = _hs_prefix_matmul_t(totals)  # inclusive
    pre = jnp.concatenate(
        [jnp.eye(K, dtype=Mt.dtype)[:, :, None], pre[:, :, :-1]], axis=2
    )  # exclusive cross-group prefixes
    # out[i,k,q,r] = sum_j pre[i,j,q] * x[j,k,q,r]
    z = jnp.sum(pre[:, :, None, :, None] * x[None], axis=1)
    m = jnp.max(z, axis=(0, 1), keepdims=True)
    z = z / jnp.maximum(m, jnp.float32(1e-35))
    return z.reshape(K, K, B)


def _hs_suffix_compose_t(maps_t: jax.Array) -> jax.Array:
    """Hillis-Steele suffix compositions over the minor axis of a (K, B)
    stack (base case / cross-group totals), identity-padded on the right;
    the composition gather is a K-way one-hot select (pure elementwise, no
    cross-lane gather)."""
    K, B = maps_t.shape
    ident = jnp.arange(K, dtype=maps_t.dtype)[:, None]
    x = maps_t
    d = 1
    while d < B:
        pad = jnp.broadcast_to(ident, (K, d))
        shifted = jnp.concatenate([x[:, d:], pad], axis=1)  # x[b+d]
        # combined[j,b] = x[shifted[j,b], b]
        acc = jnp.zeros_like(x)
        for i in range(K):
            acc = acc + jnp.where(shifted == i, x[i][None, :], 0)
        x = acc
        d <<= 1
    return x


def suffix_compose_scan_t(maps_t: jax.Array) -> jax.Array:
    """Suffix compositions r_b = m_b ∘ m_{b+1} ∘ ... of index maps in
    transposed layout (K, B) int32 (r_b[j] = m_b[r_{b+1}[j]]).

    Two-level blocked form mirroring prefix_matmul_scan_t: in-group
    reverse Hillis-Steele over (K, G, 128), a cross-group scan of the
    (K, G) whole-group compositions, then one broadcast composition."""
    K, B = maps_t.shape
    if B <= 2 * _GROUP or (B % _GROUP):
        return _hs_suffix_compose_t(maps_t)
    G = B // _GROUP
    x = maps_t.reshape(K, G, _GROUP)
    ident3 = jnp.arange(K, dtype=maps_t.dtype)[:, None, None]
    d = 1
    while d < _GROUP:  # in-group suffix compositions
        pad = jnp.broadcast_to(ident3, (K, G, d))
        shifted = jnp.concatenate([x[..., d:], pad], axis=-1)
        acc = jnp.zeros_like(x)
        for i in range(K):
            acc = acc + jnp.where(shifted == i, x[i][None], 0)
        x = acc
        d <<= 1
    totals = x[..., 0]  # (K, G) whole-group compositions
    after = _hs_suffix_compose_t(totals)
    ident2 = jnp.broadcast_to(
        jnp.arange(K, dtype=maps_t.dtype)[:, None], (K, 1)
    )
    after = jnp.concatenate([after[:, 1:], ident2], axis=1)  # groups > q
    # out[j,q,r] = x[after[j,q], q, r]
    acc = jnp.zeros_like(x)
    for i in range(K):
        acc = acc + jnp.where((after == i)[:, :, None], x[i][None], 0)
    return acc.reshape(K, B)


def forward_columns_t(
    log_e_t: jax.Array,
    sizes: jax.Array,
    n_blocks: jax.Array,
    A: jax.Array,
    pi: jax.Array,
    use_self_transitions: bool,
) -> tuple[jax.Array, jax.Array]:
    """forward_columns in transposed (K, B) layout. Returns (cols_t, last_col)
    with cols_t: (K, B)."""
    K, B = log_e_t.shape
    sizes_f = sizes.astype(jnp.float32)  # (B,)
    valid = jnp.arange(B) < n_blocks  # (B,)

    log_a_ss = jnp.log(jnp.diagonal(A))  # (K,)
    E = log_e_t
    if use_self_transitions:
        E = E + (sizes_f[None, :] - 1.0) * log_a_ss[:, None]
    e = jnp.exp(E - jnp.max(E, axis=0, keepdims=True))  # (K, B)
    M = A[:, :, None] * e[None, :, :]  # (K, K, B): M[i,j,b] = A[i,j] e[j,b]
    M = jnp.where(
        valid[None, None, :], M, jnp.eye(K, dtype=M.dtype)[:, :, None]
    )
    P = prefix_matmul_scan_t(M)  # (K, K, B)
    alpha = jnp.sum(pi[:, None, None] * P, axis=0)  # (K, B)
    alpha = alpha / jnp.maximum(
        jnp.sum(alpha, axis=0, keepdims=True), jnp.float32(1e-35)
    )

    last_col = jnp.take(alpha, jnp.maximum(n_blocks - 1, 0), axis=1)  # (K,)
    if use_self_transitions:
        is_last = (jnp.arange(B) == n_blocks - 1)[None, :]
        scale = jnp.exp((sizes_f[None, :] - 1.0) * log_a_ss[:, None])
        cols = jnp.where(is_last, alpha, alpha * scale)
    else:
        cols = alpha
    return cols, last_col


def backward_sample_t(
    key: jax.Array,
    cols_t: jax.Array,
    last_col: jax.Array,
    n_blocks: jax.Array,
    A: jax.Array,
) -> jax.Array:
    """backward_sample in transposed layout (cols_t: (K, B)); returns (B,)."""
    K, B = cols_t.shape
    k_last, k_maps = jax.random.split(key)

    z_last = jax.random.categorical(k_last, jnp.log(last_col)[None, :])[0]

    logits = (
        jnp.log(jnp.maximum(cols_t, jnp.float32(1e-38)))[:, None, :]
        + jnp.log(jnp.maximum(A, jnp.float32(1e-38)))[:, :, None]
    )  # (i, j, b)
    gumbel = jax.random.gumbel(k_maps, (K, K, B), dtype=jnp.float32)
    pred = jnp.argmax(logits + gumbel, axis=0).astype(jnp.int32)  # (j, b)

    ident = jnp.broadcast_to(jnp.arange(K, dtype=jnp.int32)[:, None], (K, B))
    use_pred = (jnp.arange(B) < n_blocks - 1)[None, :]
    maps = jnp.where(use_pred, pred, ident)

    r = suffix_compose_scan_t(maps)  # (K, B)
    return jnp.take(r, z_last, axis=0).astype(jnp.int32)


def fb_sample_states(
    key: jax.Array,
    block_stats_t: jax.Array,  # (dim, 2, B) — ops.blocks.block_sufficient_stats_t
    sizes: jax.Array,
    n_blocks: jax.Array,
    theta_mean: jax.Array,
    theta_var: jax.Array,
    A: jax.Array,
    pi: jax.Array,
    mapping: jax.Array,
    use_self_transitions: bool = True,
) -> jax.Array:
    """Sample a per-block state path with the FB-Gibbs kernel. (B,) int32.

    Internally runs in transposed (K, B) layout: with the block axis minor,
    every per-block array is long and contiguous."""
    from hammlet_tpu.models.distributions import emission_log_weights_t

    log_e_t = emission_log_weights_t(
        block_stats_t, sizes, theta_mean, theta_var, mapping
    )
    cols_t, last_col = forward_columns_t(
        log_e_t, sizes, n_blocks, A, pi, use_self_transitions
    )
    return backward_sample_t(key, cols_t, last_col, n_blocks, A)
