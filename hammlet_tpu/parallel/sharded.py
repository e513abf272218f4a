"""Position-sharded Gibbs sweep over a device mesh.

The reference is strictly single-threaded (SURVEY.md §2.3); this module is
the new distributed design. The position axis is sharded over a 1-D mesh.
Each sweep exchanges only O(P * K^2) scalars between shards:

- block boundaries: each shard thresholds its local weights; a block whose
  start lies in shard k extends to the first boundary of any later shard,
  found from an all_gather of P per-shard first-boundary positions. Block
  *identity* is exactly the single-device (= reference) partition; blocks
  are never split at shard edges.
- block statistics: fully local via the cell-structured prefix sums (shard
  sizes are cell-aligned and each shard holds one extra R entry for its
  right edge), plus the all-gathered per-shard "head" statistics for blocks
  spanning shards.
- forward pass: local associative scans of K x K block matrices, then a
  cross-shard prefix over the P gathered shard-total matrices.
- backward pass: local random-map suffix compositions, then a cross-shard
  suffix over the P gathered shard-total maps; the final state is drawn
  identically on every shard from the shared key.
- sweep statistics are all_gathered and summed in shard order (transport-
  invariant, unlike psum) and the conjugate model update runs replicated
  (same key -> identical new model on all shards and all hosts).

The marginal count buffers stay sharded with the position axis, so a 3 Gbp
genome's counts never materialize on one chip.

Layout: T is padded to T_pad = P * T_local with T_local a multiple of the
prefix-cell size; padding weights are -inf (never boundaries) and padded
data is zero, so the block partition of [0, T) is untouched and padding
positions belong to no block.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass, field

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
try:
    from jax import shard_map
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map

from hammlet_tpu.io.records import Records
from hammlet_tpu.models.hmm import (
    HMMPriors,
    HMMState,
    ModelSpec,
    SweepStats,
    resample_model,
    sample_from_priors,
)
from hammlet_tpu.models.distributions import emission_log_weights_t
from hammlet_tpu.parallel.mesh import POS_AXIS, position_mesh
from hammlet_tpu.samplers.forward_backward import (
    _compose_maps_rev,
    _scaled_matmul,
    prefix_matmul_scan_t,
    suffix_compose_scan_t,
)
from hammlet_tpu.samplers.sweep import accumulate_sweep_stats


def _replicated_fetch(mesh: Mesh, x) -> np.ndarray:
    """np.asarray for arrays that may span processes: multi-host shards are
    not addressable locally, so replicate through one jitted identity (an
    all-gather across hosts) first. Single-process arrays fetch directly."""
    if getattr(x, "is_fully_addressable", True):
        return np.asarray(x)
    rep = NamedSharding(mesh, P())
    return np.asarray(jax.jit(lambda v: v, out_shardings=rep)(x))


def _sharded_sweep_body(
    key,
    model: HMMState,
    priors: HMMPriors,
    negw_l,  # (T_local,) ascending sort of -weights, local to the shard
    candpos_l,  # (cap_local+1,) per-shard position-sorted candidates (+T_local sentinel)
    candrank_l,  # (cap_local,) local weight rank of each candidate
    r_l,  # (dim*2, T_local+1) local in-cell reverse prefix component rows
    q2_hi,  # (n_cells + 1, dim, 2) replicated
    q2_lo,
    counts_l,  # (K*T_local,) local FLAT marginal diff accumulator
    everb_l,  # (T_local,) local boundary union
    n_rec,
    n_bound,  # () int32 replicated popcount of the global boundary union
    do_record,
    use_dynamic,
    static_threshold,
    *,
    method: str,
    cap_local: int,
    T: int,
    T_local: int,
    cell_bits: int,
    mapping_np: np.ndarray,
    nr_params: int,
    use_self_transitions: bool,
    record: bool = True,
    debug: bool = False,
):
    """Per-shard sweep body (runs under shard_map along the 'pos' axis).
    ``record`` is STATIC: non-recording phases compile without the
    marginal-update scatters; STATIC ``debug`` compiles in the invariant
    bitmask (hammlet_tpu.debug)."""
    nP = jax.lax.axis_size(POS_AXIS)
    k = jax.lax.axis_index(POS_AXIS)
    shard_start = (k * T_local).astype(jnp.int32)
    shard_end = shard_start + T_local
    mapping = jnp.asarray(mapping_np)
    K = mapping.shape[0]

    dim = q2_hi.shape[1]
    r3 = r_l.reshape(dim, 2, -1)  # (dim, 2, T_local+1) component view
    # (2, dim, 2, n_cells+1) hi/lo stack — tiny and loop-invariant
    q2c = jnp.stack(
        [jnp.transpose(q2_hi, (1, 2, 0)), jnp.transpose(q2_lo, (1, 2, 0))]
    )

    def query_t(s_glob, e_glob):
        """Block stats for global [s, e) with both endpoints in
        [shard_start, shard_end] — (dim, 2, B) block-axis-minor layout
        (long axis contiguous, as in ops.blocks.block_sufficient_stats_t).
        FOUR minor-axis gathers total: fewer, larger ops than the
        per-component 1-D formulation, which is kept only for huge
        capacities (below)."""
        ls = s_glob - shard_start
        le = e_glob - shard_start
        cs = (s_glob >> cell_bits).astype(jnp.int32)
        ce = (e_glob >> cell_bits).astype(jnp.int32)
        from hammlet_tpu.ops.blocks import _BS_FUSED_MAX_CAP

        if s_glob.shape[0] > _BS_FUSED_MAX_CAP:
            # near-T_local burn-in capacities: per-component 1-D gathers
            # bound the gather's transient to one (B,) row at a time
            # (see ops.blocks.block_sufficient_stats_t)
            comps = []
            for d in range(dim):
                for c in range(2):
                    r1 = r3[d, c]
                    qh = q2_hi[:, d, c]
                    ql = q2_lo[:, d, c]
                    comps.append(
                        (r1[ls] - r1[le])
                        + ((qh[ce] - qh[cs]) + (ql[ce] - ql[cs]))
                    )
            return jnp.stack(comps).reshape(dim, 2, -1)
        r_s = r3[:, :, ls]  # (dim, 2, B)
        r_e = r3[:, :, le]
        q_s = q2c[:, :, :, cs]  # (2, dim, 2, B)
        q_e = q2c[:, :, :, ce]
        qd = q_e - q_s
        return (r_s - r_e) + (qd[0] + qd[1])

    def query(s_glob, e_glob):
        """Scalar-endpoint query -> (dim, 2) (the per-shard head stats)."""
        return query_t(s_glob[None], e_glob[None])[:, :, 0]

    thr = jnp.where(use_dynamic, model.threshold(T), static_threshold)

    # ---- local block boundaries (pre-sorted bucket candidates; the only
    # per-sweep work is a saturating masked count + masked nonzero; exact
    # whenever the sweep fits cap_local, which is the only case whose
    # count is used — see ops.blocks.make_blocks_bucketed) ----
    neg_head = jax.lax.slice(
        negw_l, (0,), (min(cap_local + 1, negw_l.shape[0]),)
    )
    nb_l = jnp.sum(neg_head <= -thr, dtype=jnp.int32)
    valid_c = candrank_l < nb_l
    csum = jnp.cumsum(valid_c.astype(jnp.int32))
    sel = jnp.full((cap_local,), cap_local, jnp.int32)
    sel = sel.at[jnp.where(valid_c, csum - 1, cap_local)].set(
        jnp.arange(cap_local, dtype=jnp.int32), mode="drop"
    )
    lstarts = candpos_l[sel]  # padded entries hit the T_local sentinel
    gstarts = lstarts + shard_start  # padded -> shard_end
    bidx = jnp.arange(cap_local)
    valid_b = bidx < nb_l
    is_last_real = bidx == nb_l - 1

    first_b = jnp.where(nb_l > 0, gstarts[0], T).astype(jnp.int32)
    firsts_all = jax.lax.all_gather(first_b, POS_AXIS)  # (P,)
    shard_ids = jnp.arange(nP, dtype=jnp.int32)
    later_first = jnp.where(shard_ids > k, firsts_all, T)
    next_boundary = jnp.min(later_first).astype(jnp.int32)  # default T

    gends_next = jnp.concatenate([gstarts[1:], shard_end[None]])
    gends = jnp.where(is_last_real, next_boundary, gends_next)
    sizes = gends - gstarts  # padded blocks: shard_end - shard_end = 0

    # ---- block sufficient statistics ------------------------------------
    # all blocks as if they end inside the shard (the last real one is cut
    # at shard_end), then add gathered heads for the shards the last block
    # spans. (dim, 2, B) block-axis-minor layout throughout.
    e_local = jnp.minimum(gends, shard_end)
    stats_local = query_t(gstarts, e_local)  # (dim, 2, B)

    head_end = jnp.clip(
        jnp.minimum(first_b, shard_end), shard_start, shard_end
    ).astype(jnp.int32)
    head_stat = query(shard_start, head_end)  # (dim, 2)
    heads_all = jax.lax.all_gather(head_stat, POS_AXIS)  # (P, dim, 2)

    include = (shard_ids > k) & (shard_ids * T_local < next_boundary)
    tail_extra = jnp.sum(
        jnp.where(include[:, None, None], heads_all, 0.0), axis=0
    )  # (dim, 2)
    bstats = stats_local + jnp.where(
        (is_last_real & (gends > shard_end))[None, None, :],
        tail_extra[:, :, None],
        0.0,
    )

    # ---- state sampling --------------------------------------------------
    k_z, k_model, k_local = jax.random.split(key, 3)
    k_maps = jax.random.fold_in(k_local, k)

    # transposed (K, B) layout throughout: block axis minor
    log_e_t = emission_log_weights_t(
        bstats, sizes, model.theta_mean, model.theta_var, mapping
    )

    nb_all = jax.lax.all_gather(nb_l, POS_AXIS)  # (P,)

    if method == "M":
        gumbel = jax.random.gumbel(k_maps, (K, cap_local), dtype=jnp.float32)
        z_l = jnp.where(
            valid_b, jnp.argmax(log_e_t + gumbel, axis=0).astype(jnp.int32), 0
        )
    elif method == "F":
        sizes_f = sizes.astype(jnp.float32)
        log_a_ss = jnp.log(jnp.diagonal(model.A))
        E = log_e_t
        if use_self_transitions:
            E = E + (sizes_f[None, :] - 1.0) * log_a_ss[:, None]
        e_w = jnp.exp(E - jnp.max(E, axis=0, keepdims=True))  # (K, B)
        M = model.A[:, :, None] * e_w[None, :, :]  # (K, K, B)
        M = jnp.where(
            valid_b[None, None, :], M, jnp.eye(K, dtype=M.dtype)[:, :, None]
        )

        L = prefix_matmul_scan_t(M)  # (K, K, B)
        tots_all = jax.lax.all_gather(L[:, :, -1], POS_AXIS)  # (P, K, K)

        # cross-shard prefix products in log depth (a sequential per-shard
        # loop over P totals would be O(P) latency per sweep)
        tot_prefix = jax.lax.associative_scan(
            _scaled_matmul, tots_all, axis=0
        )  # inclusive: (P, K, K)
        pre = jnp.where(
            k == 0,
            jnp.eye(K, dtype=jnp.float32),
            tot_prefix[jnp.maximum(k - 1, 0)],
        )
        v_pre = jnp.dot(
            model.pi, pre, precision=jax.lax.Precision.HIGHEST
        )  # (K,)
        alpha = jnp.sum(v_pre[:, None, None] * L, axis=0)  # (K, B)
        alpha = alpha / jnp.maximum(
            jnp.sum(alpha, axis=0, keepdims=True), jnp.float32(1e-35)
        )

        v_last = jnp.dot(
            model.pi, tot_prefix[-1], precision=jax.lax.Precision.HIGHEST
        )
        last_col = v_last / jnp.maximum(jnp.sum(v_last), jnp.float32(1e-35))

        m_star = jnp.max(jnp.where(nb_all > 0, shard_ids, -1))
        is_global_last = (k == m_star) & is_last_real  # (B,)

        if use_self_transitions:
            scale = jnp.exp((sizes_f[None, :] - 1.0) * log_a_ss[:, None])
            cols = jnp.where(is_global_last[None, :], alpha, alpha * scale)
        else:
            cols = alpha

        z_last = jax.random.categorical(
            k_z, jnp.log(jnp.maximum(last_col, 1e-38))[None, :]
        )[0]

        logits = (
            jnp.log(jnp.maximum(cols, jnp.float32(1e-38)))[:, None, :]
            + jnp.log(jnp.maximum(model.A, jnp.float32(1e-38)))[:, :, None]
        )  # (i, j, b)
        gumbel = jax.random.gumbel(
            k_maps, (K, K, cap_local), dtype=jnp.float32
        )
        pred = jnp.argmax(logits + gumbel, axis=0).astype(jnp.int32)  # (j, b)
        ident = jnp.broadcast_to(
            jnp.arange(K, dtype=jnp.int32)[:, None], (K, cap_local)
        )
        use_pred = valid_b[None, :] & (~is_global_last[None, :])
        maps = jnp.where(use_pred, pred, ident)  # (K, B)

        r_suffix = suffix_compose_scan_t(maps)  # (K, B)
        tmaps_all = jax.lax.all_gather(r_suffix[:, 0], POS_AXIS)  # (P, K)

        # cross-shard suffix composition in log depth: after = the
        # composition of all shard-total maps strictly after this shard
        suffix_all = jax.lax.associative_scan(
            _compose_maps_rev, tmaps_all, axis=0, reverse=True
        )  # inclusive: (P, K)
        after = jnp.where(
            k == nP - 1,
            jnp.arange(K, dtype=jnp.int32),
            suffix_all[jnp.minimum(k + 1, nP - 1)],
        )
        z_l = jnp.take(r_suffix, after[z_last], axis=0)  # (B,)
    else:  # pragma: no cover
        raise ValueError(f"unknown sampling method {method!r}")

    # ---- carry states across shards -------------------------------------
    # the chain state entering this shard = the last block state of the
    # highest-indexed earlier shard that has any blocks (vectorized masked
    # argmax instead of a sequential O(P) loop)
    last_state_l = jnp.where(nb_l > 0, z_l[jnp.maximum(nb_l - 1, 0)], 0)
    laststates_all = jax.lax.all_gather(last_state_l, POS_AXIS)  # (P,)
    prev_valid = (shard_ids < k) & (nb_all > 0)
    jbest = jnp.max(jnp.where(prev_valid, shard_ids, -1))
    carry_state = jnp.where(
        jbest >= 0, laststates_all[jnp.maximum(jbest, 0)], jnp.int32(0)
    )

    # ---- sweep statistics (local, then psum) ----------------------------
    stats = accumulate_sweep_stats(z_l, sizes, nb_l, bstats, mapping, nr_params)
    # accumulate_sweep_stats used prev=0 for the first local block; replace
    # with the carried state (the global chain's previous block state)
    has_blocks = nb_l > 0
    z0 = z_l[0]
    delta = jnp.where(has_blocks, 1.0, 0.0)
    trans_counts = (
        stats.trans_counts.at[0, z0].add(-delta).at[carry_state, z0].add(delta)
    )
    # cross-shard reduction as all_gather + ordered sum instead of psum: a
    # psum's float32 reduction order varies with the transport (in-process
    # XLA vs cross-host rings), which would make a multi-host run diverge
    # bit-wise from the same mesh in one process; shard-index-ordered sums
    # are transport-invariant. The payload is O(P * K^2) floats per sweep.
    def _osum(x):
        return jnp.sum(jax.lax.all_gather(x, POS_AXIS), axis=0)

    stats = SweepStats(
        theta_sums=_osum(stats.theta_sums),
        theta_sumsqs=_osum(stats.theta_sumsqs),
        theta_counts=_osum(stats.theta_counts),
        trans_counts=_osum(trans_counts),
        state_counts=_osum(stats.state_counts),
    )
    new_model = resample_model(k_model, priors, stats)

    # ---- recording (sharded) --------------------------------------------
    overflow = jnp.max(nb_all) > cap_local

    # O(#local blocks) boundary-difference recording (see
    # samplers.sweep.record_sweep): +1 at each local block start with its
    # state, -1 with the PREVIOUS state — the previous state of a shard's
    # first block is the carried cross-shard state, which also closes the
    # block spanning in from earlier shards. Decoding is a global cumsum
    # along the position axis at save time (cross-shard carry included).
    # Runs in recording phases only (STATIC record flag), predicated by
    # pushing indices out of bounds (a lax.cond here interacted
    # pathologically with the scanned sweep; see samplers.sweep.record_sweep).
    if record:
        rec = do_record & ~overflow
        z_prev = jnp.concatenate([carry_state[None], z_l[:-1]])
        oob = jnp.int32(K * T_local)
        valid_s = valid_b & (gstarts < T) & rec
        inc = jnp.where(valid_s, z_l * T_local + lstarts, oob)
        counts_l = counts_l.at[inc].add(1, mode="drop")
        dec_ok = valid_s & (gstarts > 0)
        dec = jnp.where(dec_ok, z_prev * T_local + lstarts, oob)
        counts_l = counts_l.at[dec].add(-1, mode="drop")
        chg = dec_ok & (z_l != z_prev)
        # count newly-created boundaries before setting them (O(#blocks)
        # local gather + one psum; feeds the segments stream without any
        # O(T) reduction on the sweep path)
        was_set = jnp.where(
            chg, everb_l[jnp.minimum(lstarts, T_local - 1)], True
        )
        newly = jnp.sum((chg & ~was_set).astype(jnp.int32))
        everb_l = everb_l.at[jnp.where(chg, lstarts, T_local)].set(
            True, mode="drop"
        )
        n_rec = n_rec + jnp.where(rec, 1, 0)
        n_bound = n_bound + jax.lax.psum(newly, POS_AXIS)

    if debug:
        from hammlet_tpu.debug import model_error_bits

        # input model checked too: a poisoned parameter must fail the sweep
        # that sampled from it (Observation.hpp:374-392 setter guards)
        err = model_error_bits(model, bstats) | model_error_bits(new_model)
    else:
        err = jnp.int32(0)
    return (
        new_model, counts_l, everb_l, n_rec, n_bound, z_l, sizes,
        nb_l[None], thr, err,
    )


def build_sharded_sweep(
    mesh: Mesh,
    *,
    method: str,
    cap_local: int,
    T: int,
    T_local: int,
    cell_bits: int,
    mapping_np: np.ndarray,
    nr_params: int,
    use_self_transitions: bool,
    record: bool = True,
    debug: bool = False,
):
    """Compile-ready sharded sweep: shard_map over the position axis."""
    body = functools.partial(
        _sharded_sweep_body,
        method=method,
        cap_local=cap_local,
        T=T,
        T_local=T_local,
        cell_bits=cell_bits,
        mapping_np=mapping_np,
        nr_params=nr_params,
        use_self_transitions=use_self_transitions,
        record=record,
        debug=debug,
    )
    rep = P()
    sh = P(POS_AXIS)
    specs = dict(
        mesh=mesh,
        in_specs=(rep, rep, rep, sh, sh, sh, sh, rep, rep, sh, sh, rep, rep,
                  rep, rep, rep),
        out_specs=(rep, sh, sh, rep, rep, sh, sh, sh, rep, rep),
    )
    try:
        fn = shard_map(body, check_vma=False, **specs)
    except TypeError:  # pragma: no cover - older jax uses check_rep
        fn = shard_map(body, check_rep=False, **specs)
    return jax.jit(fn, donate_argnums=(9, 10))


def build_sharded_phase(
    mesh: Mesh,
    *,
    method: str,
    cap_local: int,
    T: int,
    T_local: int,
    cell_bits: int,
    mapping_np: np.ndarray,
    nr_params: int,
    use_self_transitions: bool,
    n_iters: int,
    thinning: int = 0,  # STATIC; > 0 requires n_iters % thinning == 0
    record: bool = True,
    want_blocks: bool = False,
    debug: bool = False,
):
    """A whole chunk of sharded sweeps as one jitted program — no host
    round-trips inside a chunk (mirrors samplers.sweep.gibbs_phase).

    ``thinning`` is STATIC: the chunk runs as macros of (thinning - 1)
    QUIET sweeps compiled without the recording scatters plus one
    RECORDING sweep (a masked-out scatter still executes; see
    gibbs_phase). With STATIC ``want_blocks`` the per-RECORDED-sweep
    (states, n_boundaries) stacks feed the sequences/blocks/segments
    streams, drained once per chunk — states travel in the smallest dtype
    that fits K, and block sizes never travel at all: every shard's
    boundary set is candpos_l[candrank_l < nb_l] with the last block ending
    at the next shard's first boundary, so the driver reconstructs the
    global sizes exactly from the per-(sweep, shard) block counts plus a
    once-per-capacity host copy of the candidates."""

    def make(rec: bool):
        body = functools.partial(
            _sharded_sweep_body,
            method=method,
            cap_local=cap_local,
            T=T,
            T_local=T_local,
            cell_bits=cell_bits,
            mapping_np=mapping_np,
            nr_params=nr_params,
            use_self_transitions=use_self_transitions,
            record=rec,
            debug=debug,
        )
        rep = P()
        sh = P(POS_AXIS)
        specs = dict(
            mesh=mesh,
            in_specs=(rep, rep, rep, sh, sh, sh, sh, rep, rep, sh, sh, rep,
                      rep, rep, rep, rep),
            out_specs=(rep, sh, sh, rep, rep, sh, sh, sh, rep, rep),
        )
        try:
            return shard_map(body, check_vma=False, **specs)
        except TypeError:  # pragma: no cover
            return shard_map(body, check_rep=False, **specs)

    sweep_q = make(False)
    sweep_r = make(True) if (record and thinning >= 1) else None

    def phase(
        master_key, model, priors, negw, candpos, candrank, r, q2_hi, q2_lo,
        counts, everb, n_rec, n_bound, counter, use_dynamic,
        static_threshold,
    ):
        # one program per chunk: the chunk key, the pre-chunk snapshot (for
        # overflow replay) and the packed diagnostics all live in-graph —
        # the driver syncs once per chunk and issues no eager op between
        key = jax.random.fold_in(master_key, counter)
        prev = (counts, everb, n_rec, n_bound) if record else None

        def step(rec: bool):
            sweep = sweep_r if rec else sweep_q

            def s(carry, i):
                model, counts, everb, n_rec, n_bound = carry
                k = jax.random.fold_in(key, i)
                (model, counts, everb, n_rec, n_bound, z, sizes, nb, _thr,
                 err) = sweep(
                    k, model, priors, negw, candpos, candrank, r, q2_hi,
                    q2_lo, counts, everb, n_rec, n_bound, jnp.bool_(rec),
                    use_dynamic, static_threshold,
                )
                ys = (nb, model.theta_mean, model.theta_var, err)
                if rec and want_blocks:
                    K = mapping_np.shape[0]
                    zdt = (
                        jnp.int8 if K <= 127
                        else jnp.int16 if K <= 32767 else jnp.int32
                    )
                    ys = ys + (z.astype(zdt), n_bound)
                return (model, counts, everb, n_rec, n_bound), ys

            return s

        carry = (model, counts, everb, n_rec, n_bound)
        if not record or thinning <= 1:
            rec = record and thinning == 1
            carry, ys = jax.lax.scan(step(rec), carry, jnp.arange(n_iters))
            nbs, means, varis, errs = ys[:4]
            blk = ys[4:] if (rec and want_blocks) else None
            max_nb = jnp.max(nbs)
            last_total = jnp.sum(nbs[-1])
            max_err = jnp.max(errs)
        else:
            if n_iters % thinning:
                raise ValueError(
                    "n_iters must be a multiple of static thinning"
                )
            n_macro = n_iters // thinning

            def macro(carry, m):
                i0 = m * thinning
                carry, qys = jax.lax.scan(
                    step(False), carry, i0 + jnp.arange(thinning - 1)
                )
                carry, rys = step(True)(carry, i0 + thinning - 1)
                return carry, (qys, rys)

            carry, (qys, rys) = jax.lax.scan(
                macro, carry, jnp.arange(n_macro)
            )
            nbs, means, varis = rys[:3]
            blk = rys[4:] if want_blocks else None
            max_nb = jnp.maximum(jnp.max(qys[0]), jnp.max(nbs))
            last_total = jnp.sum(nbs[-1])
            max_err = jnp.maximum(jnp.max(qys[3]), jnp.max(rys[3]))
        model, counts, everb, n_rec, n_bound = carry
        diag = jnp.stack([max_nb, last_total, max_err]).astype(jnp.int32)
        return (
            model, counts, everb, n_rec, n_bound, prev, diag, nbs, means,
            varis, blk,
        )

    return jax.jit(phase, donate_argnums=(9, 10))


@functools.lru_cache(maxsize=None)
def _local_segment_gather(K: int, T_local: int, cap: int, is_first: bool):
    """Per-device (non-collective) jit: decode one shard's boundary-diff
    buffer and gather the counts at its segment starts, with a STATIC
    capacity sized to that shard's actual segment count (pow2 bucket).
    Compiled once per (cap, is_first) and cached."""

    @jax.jit
    def g(diff_l, everb_l):
        cum = jnp.cumsum(diff_l.reshape(K, T_local), axis=1)
        first = everb_l.at[0].set(True) if is_first else everb_l
        (starts_l,) = jnp.nonzero(first, size=cap, fill_value=T_local)
        seg = cum[:, jnp.minimum(starts_l, T_local - 1)]
        return starts_l.astype(jnp.int32), jnp.transpose(seg)

    return g


def compact_sharded_marginals(engine) -> tuple[np.ndarray, np.ndarray]:
    """RLE-compact the sharded marginal accumulators ON DEVICE and download
    only per-segment rows (the reference's whole output design keeps the
    marginal store small, StateMarginals.hpp:20-21; downloading the full
    (P*K*T_local) counts buffer at 3 Gbp would be GBs over the host link).

    Download traffic is proportional to ACTUAL segments: after one tiny
    replicated summary fetch ((P,) segment counts + (P, K) shard totals),
    every process gathers its own shards' rows with per-shard static
    capacities (pow2 buckets of the true counts — at most 2x padding), so a
    single degenerate low-compression shard (cap_seg -> T_local, the
    reference's own caveat, doc/hammlet-manpage.md:178) no longer forces a
    (P, T_local, K) worst-shard-replicated download. Cross-shard count
    carries are added on the host from the shard totals. In a multi-host
    run the per-process rows are exchanged once, padded only to the
    largest PROCESS payload.

    Returns (starts, seg_counts): global segment start positions (ascending
    int64) and the (n_seg, K) recorded counts at those starts."""
    K = engine.spec.nr_states
    T_local = engine.T_local
    mesh = engine.mesh

    def _smap(fn, in_specs, out_specs):
        try:
            return shard_map(
                fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                check_vma=False,
            )
        except TypeError:  # pragma: no cover - older jax
            return shard_map(
                fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                check_rep=False,
            )

    def summary_fn(diff_l, everb_l):
        k = jax.lax.axis_index(POS_AXIS)
        extra = jnp.where(k == 0, 1, 0)  # global position 0 starts a segment
        n = (jnp.sum(everb_l.astype(jnp.int32)) + extra)[None]
        tot = jnp.sum(diff_l.reshape(K, T_local), axis=1)[None]  # (1, K)
        return n, tot

    n_seg_d, tots_d = jax.jit(
        _smap(summary_fn, (P(POS_AXIS), P(POS_AXIS)), (P(POS_AXIS), P(POS_AXIS)))
    )(engine.counts, engine.everb)
    n_seg_shard = _replicated_fetch(mesh, n_seg_d).astype(np.int64)  # (P,)
    tots = _replicated_fetch(mesh, tots_d).astype(np.int64)  # (P, K)
    carries = np.concatenate(
        [np.zeros((1, K), np.int64), np.cumsum(tots, axis=0)[:-1]]
    )

    # map global shard id -> local device buffers (only local shards are
    # addressable; every process computes identical n_seg/carries above)
    count_shards = {
        (s.index[0].start or 0) // (K * T_local): s.data
        for s in engine.counts.addressable_shards
    }
    everb_shards = {
        (s.index[0].start or 0) // T_local: s.data
        for s in engine.everb.addressable_shards
    }
    local_rows: list[np.ndarray] = []  # (n_j, 2 + K) int32: [j, local_start, counts...]
    for j in sorted(count_shards):
        n_j = int(n_seg_shard[j])
        if n_j == 0:
            continue
        cap = min(1 << (n_j - 1).bit_length(), T_local)
        g = _local_segment_gather(K, T_local, cap, j == 0)
        starts_l, seg_l = g(count_shards[j], everb_shards[j])
        rows = np.empty((n_j, 2 + K), dtype=np.int32)
        rows[:, 0] = j
        rows[:, 1] = np.asarray(starts_l)[:n_j]
        rows[:, 2:] = np.asarray(seg_l)[:n_j]
        local_rows.append(rows)

    mine = (
        np.concatenate(local_rows)
        if local_rows
        else np.empty((0, 2 + K), dtype=np.int32)
    )
    if jax.process_count() > 1:
        # exchange per-process rows once, padded to the largest process
        # payload (not the worst shard x P)
        from jax.experimental import multihost_utils

        devices = mesh.devices.reshape(-1)
        per_proc = np.zeros(jax.process_count(), dtype=np.int64)
        for j, d in enumerate(devices):
            per_proc[d.process_index] += n_seg_shard[j]
        pad = int(per_proc.max())
        buf = np.full((pad, 2 + K), -1, dtype=np.int32)
        buf[: len(mine)] = mine
        rows = multihost_utils.process_allgather(buf).reshape(-1, 2 + K)
        rows = rows[rows[:, 0] >= 0]
    else:
        rows = mine
    order = np.lexsort((rows[:, 1], rows[:, 0]))  # global shard-major order
    rows = rows[order]
    starts = rows[:, 0].astype(np.int64) * T_local + rows[:, 1]
    seg_counts = rows[:, 2:].astype(np.int64) + carries[rows[:, 0]]
    return starts, seg_counts


def _reassemble_block_rows(
    z_h: np.ndarray,
    nbs_h: np.ndarray,
    pos_h: np.ndarray,
    rank_h: np.ndarray,
    T: int,
    T_local: int,
):
    """Reassemble a chunk's per-shard block rows into global block order,
    reconstructing block sizes from the static candidate arrays.

    z_h: (R, P*cap) per-recorded-sweep state stacks where shard j's valid
    blocks occupy [j*cap, j*cap + nbs_h[r, j]); pos_h (P, cap+1) and
    rank_h (P, cap) are the host copies of the per-shard candidates. A
    sweep's shard-j boundary positions are pos_h[j][rank_h[j] < nb] +
    j*T_local (ascending, mirroring the device compaction), and the global
    sizes are the diffs of the concatenated starts with a final T sentinel
    — which also merges blocks spanning shard edges exactly as the device
    does (the last block of a shard ends at the next shard's first
    boundary). Returns dense (R, max_total) states/sizes plus per-row
    totals for Records.record_sweeps_batch.

    The reconstruction runs in the native batch routine when the C++
    library is built (native/ingest.cpp:hammlet_reassemble_blocks — the
    per-(sweep, shard) Python selection loop was the all-streams drain
    bottleneck at many shards); the NumPy fallback caches the candidate
    selection per (shard, nb) since block counts repeat across sweeps
    once the threshold settles."""
    from hammlet_tpu import native

    R, P = nbs_h.shape
    cap = z_h.shape[1] // P
    z3 = z_h.reshape(R, P, cap)
    res = native.reassemble_blocks(z3, nbs_h, pos_h, rank_h, T, T_local)
    if res is not None:
        return res
    ns = nbs_h.sum(axis=1).astype(np.int64)
    maxn = int(ns.max()) if R else 0
    states = np.zeros((R, maxn), dtype=np.int32)
    sizes = np.zeros((R, maxn), dtype=np.int32)
    sel_cache: dict[tuple[int, int], np.ndarray] = {}
    for r_i in range(R):
        parts_pos: list[np.ndarray] = []
        parts_z: list[np.ndarray] = []
        for j in range(P):
            nb = int(nbs_h[r_i, j])
            if nb:
                key = (j, nb)
                if key not in sel_cache:
                    sel_cache[key] = (
                        pos_h[j, :-1][rank_h[j] < nb].astype(np.int64)
                        + j * T_local
                    )
                parts_pos.append(sel_cache[key])
                parts_z.append(z3[r_i, j, :nb])
        if not parts_pos:
            continue
        gstarts = np.concatenate(parts_pos)
        n_r = int(ns[r_i])
        states[r_i, :n_r] = np.concatenate(parts_z)
        sizes[r_i, :n_r] = np.diff(np.append(gstarts, T))
    return states, sizes, ns


@dataclass
class ShardedEngine:
    """Multi-device engine mirroring runner.Engine with position sharding."""

    mesh: Mesh
    spec: ModelSpec
    priors: HMMPriors
    seed: int
    T: int
    T_local: int
    cell_bits: int
    negw: jax.Array  # (T_pad,) sharded: per-shard ascending sort of -weights
    rank: jax.Array  # (T_pad,) sharded: per-shard weight-rank -> local position
    r: jax.Array  # (P*dim*2, T_local+1) sharded local R component rows
    q2_hi: jax.Array
    q2_lo: jax.Array
    records: Records | None = None
    cap_local: int = 1024
    checkpoint_path: str | None = None
    checkpoint_every: int = 0  # sweeps between checkpoints (0 = off)

    model: HMMState = field(init=False)
    sweep_counter: int = field(init=False, default=0)
    sweeps_completed: int = field(init=False, default=0)
    scheme_op_index: int = field(init=False, default=0)
    scheme_op_done: int = field(init=False, default=0)
    total_sweeps: float = field(init=False, default=0.0)
    sample_time: float = field(init=False, default=0.0)

    def __post_init__(self):
        self._key = jax.random.PRNGKey(self.seed)
        self.n_shards = self.mesh.devices.size
        K = self.spec.nr_states
        if K * self.T_local >= 2**31:
            raise ValueError(
                f"per-shard marginal index K*T_local = {K}*{self.T_local} "
                "exceeds int32; use more shards"
            )
        T_pad = self.T_local * self.n_shards
        shard = NamedSharding(self.mesh, P(POS_AXIS))
        # allocate the sharded accumulators in place (a plain jnp.zeros +
        # device_put would materialize the full-size buffer on one device
        # first — GBs at genome scale)
        self.counts = jax.jit(
            lambda: jnp.zeros((self.n_shards * K * self.T_local,), jnp.int32),
            out_shardings=shard,
        )()
        self.everb = jax.jit(
            lambda: jnp.zeros((T_pad,), bool), out_shardings=shard
        )()
        self.n_rec = jnp.zeros((), jnp.int32)
        self.n_bound = jnp.zeros((), jnp.int32)
        self.model = sample_from_priors(self._next_key(), self.priors)
        self._dynamic = True
        self._static_threshold = 0.0  # host float: passed per chunk
        self._mapping_np = self.spec.mapping()
        self._sweeps = {}
        # per-shard capacity ceiling (mirrors runner._MAX_CAPACITY: the ~T
        # burn-in capacity's transients would exhaust device memory at
        # genome-scale T_local; burn-in chunks overflowing the ceiling are
        # accepted truncated)
        from hammlet_tpu.runner import _MAX_CAPACITY

        self.max_cap_local = max(
            min(self.T_local, _MAX_CAPACITY), self.cap_local
        )

    def _next_key(self):
        self.sweep_counter += 1
        return jax.random.fold_in(self._key, self.sweep_counter)

    def _shard_candidates(self):
        """Per-shard position-sorted candidates for the current cap_local,
        computed once per capacity change under shard_map."""
        if not hasattr(self, "_cands"):
            self._cands = {}
        if self.cap_local not in self._cands:
            cap = self.cap_local
            T_local = self.T_local

            def build(rank_l):
                prefix = rank_l[:cap].astype(jnp.int32)
                order = jnp.argsort(prefix)
                pos = jnp.concatenate(
                    [prefix[order], jnp.full((1,), T_local, jnp.int32)]
                )
                return pos, order.astype(jnp.int32)

            try:
                fn = shard_map(
                    build, mesh=self.mesh,
                    in_specs=P(POS_AXIS), out_specs=P(POS_AXIS),
                    check_vma=False,
                )
            except TypeError:  # pragma: no cover
                fn = shard_map(
                    build, mesh=self.mesh,
                    in_specs=P(POS_AXIS), out_specs=P(POS_AXIS),
                    check_rep=False,
                )
            self._cands[cap] = jax.jit(fn)(self.rank)
        return self._cands[self.cap_local]

    def _sweep_fn(self, method: str, record: bool = True):
        from hammlet_tpu.debug import debug_enabled

        debug = debug_enabled()
        ck = (method, self.cap_local, record, debug)
        if ck not in self._sweeps:
            self._sweeps[ck] = build_sharded_sweep(
                self.mesh,
                method=method,
                cap_local=self.cap_local,
                T=self.T,
                T_local=self.T_local,
                cell_bits=self.cell_bits,
                mapping_np=self._mapping_np,
                nr_params=self.spec.nr_params,
                use_self_transitions=self.spec.use_self_transitions,
                record=record,
                debug=debug,
            )
        return self._sweeps[ck]

    # -- scheme ops (same protocol as runner.Engine) ----------------------

    def sample_prior(self):
        self.model = sample_from_priors(self._next_key(), self.priors)

    def set_static(self):
        self._dynamic = False
        self._static_threshold = float(self.model.threshold(self.T))

    def set_dynamic(self):
        self._dynamic = True

    def _phase_fn(
        self, method: str, n_iters: int, thinning: int = 0,
        record: bool = True, want_blocks: bool = False,
    ):
        from hammlet_tpu.debug import debug_enabled

        debug = debug_enabled()
        ck = ("phase", method, self.cap_local, n_iters, thinning, record,
              want_blocks, debug)
        if ck not in self._sweeps:
            self._sweeps[ck] = build_sharded_phase(
                self.mesh,
                method=method,
                cap_local=self.cap_local,
                T=self.T,
                T_local=self.T_local,
                cell_bits=self.cell_bits,
                mapping_np=self._mapping_np,
                nr_params=self.spec.nr_params,
                use_self_transitions=self.spec.use_self_transitions,
                n_iters=n_iters,
                thinning=thinning,
                record=record,
                want_blocks=want_blocks,
                debug=debug,
            )
        return self._sweeps[ck]

    def _current_threshold(self) -> float:
        from hammlet_tpu.models.hmm import threshold_host

        return (
            self._static_threshold
            if not self._dynamic
            else threshold_host(self.model.theta_var, self.T)
        )

    def _price_nb(self, thr: float) -> int:
        """Worst-shard boundary count at a threshold (full per-shard
        binary search; off the sweep path)."""
        if not hasattr(self, "_nb_fn"):

            def count(negw_l, t):  # per-shard (T_local,) under shard_map
                return jnp.searchsorted(negw_l, -t, side="right").astype(
                    jnp.int32
                )[None]

            specs = dict(
                mesh=self.mesh,
                in_specs=(P(POS_AXIS), P()),
                out_specs=P(POS_AXIS),
            )
            try:
                fn = shard_map(count, check_vma=False, **specs)
            except TypeError:  # pragma: no cover
                fn = shard_map(count, check_rep=False, **specs)
            self._nb_fn = jax.jit(fn)
        per_shard = _replicated_fetch(
            self.mesh, self._nb_fn(self.negw, jnp.float32(thr))
        )
        return int(per_shard.max())

    def _resize_capacity_for_phase(self) -> None:
        """Re-size cap_local to the CURRENT threshold's worst-shard
        boundary count at a phase boundary (both directions; mirrors
        runner.Engine._resize_capacity_for_phase — without this, the first
        F chunk after burn-in compiles at the stale near-T_local capacity
        left by the post-prior sweeps)."""
        from hammlet_tpu.runner import _round_capacity

        nb = self._price_nb(self._current_threshold())
        self.cap_local = min(
            self.T_local, self.max_cap_local,
            _round_capacity(nb + nb // 8 + 64),
        )

    def run(self, method: str, iterations: int, thinning: int, start: int = 0):
        if iterations <= 0:
            return
        self._resize_capacity_for_phase()
        t0 = time.time()
        self._run_phase_scanned(method, iterations, thinning, start)
        jax.block_until_ready(self.model.theta_mean)
        self.sample_time += time.time() - t0
        self.total_sweeps += iterations

    def _maybe_checkpoint(self, pending=None):
        """Checkpoint when due, draining any pending record payload first
        (mirrors runner.Engine._maybe_checkpoint: a checkpoint must not
        count sweeps whose stream lines are still undrained). Returns the
        (possibly consumed) pending payload."""
        if not self.checkpoint_path or self.checkpoint_every <= 0:
            return pending
        if (
            self.sweeps_completed - getattr(self, "_last_ckpt", 0)
            >= self.checkpoint_every
        ):
            from hammlet_tpu.checkpoint import save_sharded_checkpoint

            if pending is not None:
                self._drain_records(*pending)
                pending = None
            save_sharded_checkpoint(self, self.checkpoint_path)
            self._last_ckpt = self.sweeps_completed
        return pending

    def _run_phase_scanned(
        self, method: str, iterations: int, thinning: int, start: int = 0
    ):
        from hammlet_tpu.runner import (
            _chunk_for_capacity,
            _next_chunk,
            _round_capacity,
        )

        recording = thinning > 0
        want_blocks = (
            recording
            and self.records is not None
            and bool(
                {"sequences", "blocks", "segments"} & self.records.enabled
            )
        )
        done = start
        end = start + iterations
        pending = None  # previous chunk's record payload, drained overlapped
        while done < end:
            n, thin_s, rec_s = _next_chunk(
                done, end, thinning if recording else 0,
                # capacity-scaled chunk length (mirrors
                # runner.Engine._max_chunk: short chunks at huge per-shard
                # capacities, where a long scan multiplies compile time
                # and transients, and long chunks at small capacities to
                # amortize the fixed per-chunk launch and sync)
                _chunk_for_capacity(self.cap_local),
            )
            self.sweep_counter += 1
            counter = self.sweep_counter  # fixed across overflow replays
            while True:
                fn = self._phase_fn(
                    method, n, thin_s, rec_s, want_blocks and rec_s
                )
                candpos, candrank = self._shard_candidates()
                (model, counts, everb, n_rec, n_bound, prev, diag, nbs,
                 means, varis, blk) = fn(
                    self._key,
                    self.model,
                    self.priors,
                    self.negw,
                    candpos,
                    candrank,
                    self.r,
                    self.q2_hi,
                    self.q2_lo,
                    self.counts,
                    self.everb,
                    self.n_rec,
                    self.n_bound,
                    np.int32(counter),
                    np.bool_(self._dynamic),
                    np.float32(self._static_threshold),
                )
                # previous chunk's record drain runs between this chunk's
                # async dispatch and its host sync: fetches + formatting
                # overlap the device compute (mirrors runner.Engine)
                if pending is not None:
                    self._drain_records(*pending)
                    pending = None
                # the chunk's single host sync: [max_nb, last total, err]
                diag_h = np.asarray(diag)
                from hammlet_tpu.debug import raise_on_error

                raise_on_error(int(diag_h[2]))
                max_nb = int(diag_h[0])
                if max_nb <= self.cap_local:
                    self.counts, self.everb = counts, everb
                    self.model, self.n_rec, self.n_bound = model, n_rec, n_bound
                    break
                # device-side per-shard counts saturate at cap_local+1;
                # re-price the true worst-shard count at the pre-chunk
                # threshold for a one-jump capacity grow (mirrors
                # runner.Engine._run_phase_scanned)
                max_nb = max(max_nb, self._price_nb(self._current_threshold()))
                grown = min(
                    self.T_local, self.max_cap_local,
                    _round_capacity(2 * max_nb),
                )
                if grown <= self.cap_local:
                    # at the per-shard capacity ceiling: accept truncated
                    # burn-in chunks (the device program reduced each
                    # overflowing shard to its top-cap_local weights and
                    # masked recording); recording chunks must be exact
                    if rec_s:
                        raise RuntimeError(
                            f"recording sweep needs {max_nb} blocks on its "
                            f"worst shard but the capacity ceiling is "
                            f"{self.cap_local} (HAMMLET_MAX_CAPACITY); raise "
                            "the ceiling or extend burn-in"
                        )
                    self.counts, self.everb = counts, everb
                    self.model, self.n_rec, self.n_bound = model, n_rec, n_bound
                    break
                self.cap_local = grown
                # replay the chunk (same counter) from the in-graph snapshot
                if prev is not None:
                    (self.counts, self.everb, self.n_rec,
                     self.n_bound) = prev
                else:
                    self.counts, self.everb = counts, everb
            if self.records is not None and rec_s:
                pending = (
                    nbs, means, varis, blk, n // max(thin_s, 1),
                    self.cap_local,
                )
            done += n
            self.sweeps_completed += n
            self.scheme_op_done = done
            # track the falling block count after burn-in (mirrors
            # runner.Engine: ~linear per-sweep cost in cap_local; grows
            # back via same-key replay on overflow)
            target = min(
                self.T_local, self.max_cap_local,
                _round_capacity(max_nb + max_nb // 8 + 64),
            )
            if target < self.cap_local:
                self.cap_local = target
            pending = self._maybe_checkpoint(pending)
        if pending is not None:
            self._drain_records(*pending)

    def _shard_candidates_host(self, cap_local: int):
        """Host copies of the per-shard candidate arrays for one capacity
        (fetched once per capacity change; lets the record drain
        reconstruct block sizes without shipping them from the devices)."""
        if not hasattr(self, "_cands_h"):
            self._cands_h = {}
        if cap_local not in self._cands_h:
            candpos, candrank = self._cands[cap_local]
            pos = _replicated_fetch(self.mesh, candpos).reshape(
                self.n_shards, cap_local + 1
            )
            rank = _replicated_fetch(self.mesh, candrank).reshape(
                self.n_shards, cap_local
            )
            self._cands_h[cap_local] = (pos, rank)
        return self._cands_h[cap_local]

    def _drain_records(
        self, nbs, means, varis, blk, n_hits, cap_local
    ) -> None:
        """Drain one chunk's record stacks (see _reassemble_block_rows for
        the size-free block reconstruction)."""
        wants_comp = "compression" in self.records.enabled
        wants_params = "parameters" in self.records.enabled
        want_blocks = blk is not None
        if not (wants_comp or wants_params or want_blocks):
            return
        nbs_h = _replicated_fetch(self.mesh, nbs)  # (hits, P)
        if want_blocks:
            z_h = _replicated_fetch(self.mesh, blk[0])[:n_hits]
            nbound_h = np.asarray(blk[1])[:n_hits]
            pos_h, rank_h = self._shard_candidates_host(cap_local)
            states, szs, ns_tot = _reassemble_block_rows(
                z_h.astype(np.int32), nbs_h[:n_hits], pos_h, rank_h,
                self.T, self.T_local,
            )
            self.records.record_sweeps_batch(
                states, szs, ns_tot, nbound_h
            )
        elif wants_comp:
            for t in nbs_h.sum(axis=1)[:n_hits]:
                self.records.record_compression(int(t))
        if wants_params:
            means_h = np.asarray(means)
            varis_h = np.asarray(varis)
            for j in range(n_hits):
                self.records.record_theta(means_h[j], varis_h[j])

    def _record_sharded_sweep(
        self, z_flat: np.ndarray, sizes_flat: np.ndarray,
        nb_per_shard: np.ndarray, n_bound: int,
    ) -> None:
        """Reassemble per-shard (states, sizes) rows into the global block
        order and feed the sequences/blocks/segments streams."""
        z2 = z_flat.reshape(self.n_shards, -1)
        s2 = sizes_flat.reshape(self.n_shards, -1)
        states = np.concatenate(
            [z2[j, : nb_per_shard[j]] for j in range(self.n_shards)]
        )
        szs = np.concatenate(
            [s2[j, : nb_per_shard[j]] for j in range(self.n_shards)]
        )
        self.records.record_sweep(states, szs, int(nb_per_shard.sum()), n_bound)

    def _one_sweep(self, method: str, do_record: bool):
        """Single-sweep entry point (test/debug surface; phases run scanned)."""
        key = self._next_key()
        while True:
            fn = self._sweep_fn(method, do_record)
            candpos, candrank = self._shard_candidates()
            (new_model, counts, everb, n_rec, n_bound, z, sizes, nb_shard,
             thr, err) = fn(
                key,
                self.model,
                self.priors,
                self.negw,
                candpos,
                candrank,
                self.r,
                self.q2_hi,
                self.q2_lo,
                self.counts,
                self.everb,
                self.n_rec,
                self.n_bound,
                np.bool_(do_record),
                np.bool_(self._dynamic),
                np.float32(self._static_threshold),
            )
            self.counts, self.everb = counts, everb
            from hammlet_tpu.debug import raise_on_error

            raise_on_error(int(np.asarray(err)))
            nb = _replicated_fetch(self.mesh, nb_shard)
            if int(nb.max()) <= self.cap_local:
                break
            self.cap_local = min(
                self.T_local, max(self.cap_local * 2, int(nb.max() * 2))
            )
        self.model = new_model
        self.n_rec = n_rec
        self.n_bound = n_bound
        if self.records is not None and do_record:
            if self.records.wants_block_level():
                self._record_sharded_sweep(
                    _replicated_fetch(self.mesh, z),
                    _replicated_fetch(self.mesh, sizes), nb, int(n_bound)
                )
            self.records.record_theta(
                np.asarray(new_model.theta_mean),
                np.asarray(new_model.theta_var),
            )

    def run_scheme(self, tokens: list[str]):
        from hammlet_tpu.runner import run_scheme_resumable

        run_scheme_resumable(self, tokens)

    def finalize(self):
        if self.records is not None:
            if "marginals" in self.records.enabled:
                # device-side RLE: only per-segment rows leave the devices
                starts, seg_counts = compact_sharded_marginals(self)
                from hammlet_tpu.debug import check_marginal_sums

                # save-time invariant (StateMarginals.hpp:306-308)
                check_marginal_sums(seg_counts, int(np.asarray(self.n_rec)))
                self.records.save_marginals_from_segments(starts, seg_counts)
            self.records.close()

    @property
    def marginal_counts(self) -> np.ndarray:
        """(K, T) decoded marginal state counts. The flat per-shard diff
        buffers concatenate as (P, K, T_local); transpose to the global
        (K, T_pad) order, cumsum along positions, slice to T."""
        K = self.spec.nr_states
        d = (
            _replicated_fetch(self.mesh, self.counts)
            .reshape(self.n_shards, K, self.T_local)
            .transpose(1, 0, 2)
            .reshape(K, self.n_shards * self.T_local)
        )
        return np.cumsum(d.astype(np.int64), axis=1)[:, : self.T].astype(
            np.int32
        )

    @property
    def sweeps_per_second(self) -> float:
        return self.total_sweeps / max(self.sample_time, 1e-9)

    def metrics(self) -> dict:
        sps = self.sweeps_per_second
        return {
            "sweeps": self.total_sweeps,
            "sweeps_per_second": sps,
            "positions_per_second": sps * self.T,
            "positions_per_second_per_chip": sps * self.T / self.n_shards,
            "n_devices": self.n_shards,
            "block_capacity_per_shard": self.cap_local,
            "recorded_sweeps": int(np.asarray(self.n_rec)),
        }


def _choose_layout(T: int, n_shards: int) -> tuple[int, int]:
    """(T_local, cell_bits): shard size cell-aligned, cells <= 2^16."""
    t0 = -(-T // n_shards)  # ceil
    cell_bits = min(16, max(2, (max(t0, 4) - 1).bit_length()))
    cell = 1 << cell_bits
    T_local = -(-t0 // cell) * cell
    return T_local, cell_bits


def _local_r_with_edges(r_pad: np.ndarray, n_shards: int, T_local: int, cell: int):
    """Rearrange the global R ((T_pad, dim, 2), position-major) into the
    sharded engine's per-shard layout: (n_shards * dim * 2, T_local + 1)
    position-axis-minor component rows, the extra column being
    R[shard_end] = the full sum of the cell starting at the shard's right
    edge (0 for the last shard)."""
    dim = r_pad.shape[1]
    out = np.zeros((n_shards * dim * 2, T_local + 1), dtype=np.float32)
    for j in range(n_shards):
        lo = j * T_local
        blk = np.zeros((T_local + 1, dim, 2), dtype=np.float32)
        blk[:T_local] = r_pad[lo : lo + T_local]
        edge = (j + 1) * T_local
        if edge < n_shards * T_local:
            blk[T_local] = r_pad[edge]
        # else: 0 (sum over empty region)
        out[j * dim * 2 : (j + 1) * dim * 2] = blk.transpose(1, 2, 0).reshape(
            dim * 2, T_local + 1
        )
    return out


def make_sharded_engine(
    data,
    mesh: Mesh | None = None,
    n_devices: int | None = None,
    T: int | None = None,
    dim: int | None = None,
    nr_params: int = 3,
    nr_data_dim: int = 1,
    seed: int = 0,
    s2: float = 0.2,
    p: float = 0.9,
    trans: float = 0.5,
    self_trans: float = 0.5,
    initial_alpha: float = 0.5,
    weight_multiplier: float = 1.0,
    use_self_transitions: bool = True,
    records: Records | None = None,
    cap_local: int | None = None,
) -> ShardedEngine:
    """Ingest + auto-priors + sharded engine construction.

    Ingest runs shard by shard with bounded host memory (O(T_local * dim)
    peak instead of O(T); see parallel/ingest.py). ``data`` is either the
    (T, dim) array or a provider ``f(start, stop) -> chunk`` with explicit
    T/dim, so genome-scale inputs can stream from disk without ever being
    resident."""
    from hammlet_tpu.parallel.ingest import sharded_ingest

    if mesh is None:
        mesh = position_mesh(n_devices)
    n_shards = mesh.devices.size
    if not callable(data):
        data = np.asarray(data, dtype=np.float32)
        if data.ndim == 1:
            data = data[:, None]
        T, dim = data.shape
    elif T is None or dim is None:
        raise ValueError("T and dim are required with a data provider")
    T_local, cell_bits = _choose_layout(T, n_shards)

    ing = sharded_ingest(
        mesh, data, T, dim,
        T_local=T_local, cell_bits=cell_bits,
        weight_multiplier=weight_multiplier,
    )

    spec = ModelSpec(nr_params, nr_data_dim, use_self_transitions)
    # auto-prior closed form from the streamed block means
    # (AutoPriors.hpp:86-107; same reduction as autoprior_host)
    from hammlet_tpu.models.autopriors import nig_autoprior

    S, S2, n = ing.block_means
    n = max(n, 1.0)
    mean = S / n
    var = S2 / n - mean * mean
    nig_row = nig_autoprior(s2, p, float(mean), float(var))
    nig = np.tile(nig_row, (nr_params, 1))
    priors = HMMPriors.create(nig, spec.nr_states, trans, self_trans, initial_alpha)

    if cap_local is None:
        from hammlet_tpu.runner import _MAX_CAPACITY

        # clamp the initial sizing by the capacity ceiling too (mirrors
        # runner.Engine.__post_init__): the prior-threshold boundary count
        # is ~T, and a first chunk at ~T_local capacity OOMs at genome scale
        cap_local = min(
            T_local, _MAX_CAPACITY, max(64, 4 * ing.nb0 // n_shards + 64)
        )

    return ShardedEngine(
        mesh=mesh,
        spec=spec,
        priors=priors,
        seed=seed,
        T=T,
        T_local=T_local,
        cell_bits=cell_bits,
        negw=ing.negw,
        rank=ing.rank,
        r=ing.r,
        q2_hi=ing.q2_hi,
        q2_lo=ing.q2_lo,
        records=records,
        cap_local=cap_local,
    )
