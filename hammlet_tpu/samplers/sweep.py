"""The fused Gibbs sweep: one jitted program per iteration.

Replaces the reference's sampleHMM loop body (src/HMM.hpp:99-121) and the
three passes of the state-sequence samplers with a single XLA program:

    threshold -> blocks -> block stats -> state draw (FB | mixture)
    -> segment-reduced sweep statistics -> conjugate model resample
    -> (optional) on-device marginal recording

Dynamic block counts are handled with a static block capacity and masking, so
the program compiles once; the driver grows the capacity (recompiling) only
if a sweep overflows it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from hammlet_tpu.models.hmm import (
    HMMPriors,
    HMMState,
    SweepStats,
    resample_model,
)
from hammlet_tpu.ops.blocks import (
    PrefixStats,
    RankedWeights,
    block_sufficient_stats_t,
    bucket_candidates,
    make_blocks_bucketed,
)
from hammlet_tpu.samplers.forward_backward import fb_sample_states
from hammlet_tpu.samplers.mixture import mixture_sample_states

#: every float32 product below carries counts and sums of up to ~T values;
#: at the backend's default precision a GPU may round the inputs to TF32
#: (~3 significant digits), so each product pins full float32
_HIGHEST = jax.lax.Precision.HIGHEST


class RecordBuffers(NamedTuple):
    """On-device posterior recording state.

    counts:        FLAT (K*T,) int32 — BOUNDARY-DIFFERENCE accumulator of
                   the per-position state counts: for every recorded block
                   [s, e) in state z, +1 at z*T+s and -1 at z*T+e. The
                   actual marginal counts are cumsum(counts.reshape(K, T),
                   axis=1), decoded once at save/inspection time. Recording
                   a sweep therefore costs O(#blocks) scatters instead of
                   an O(K*T) per-position one-hot expansion.
                   The buffer stays PERMANENTLY flat, so no sweep pays a
                   (K, T)<->flat relayout (an O(K*T) copy per recorded
                   sweep).
    ever_boundary: (T,) bool — positions that started a segment in any
                   recorded sweep; the union partition reproduces the
                   reference's marginal segment refinement
                   (StateMarginals.hpp:51-137)
    n_records:     () int32 — number of recorded sweeps
    n_boundaries:  () int32 — running popcount of ever_boundary, maintained
                   with an O(#blocks) gather per recorded sweep so the
                   segments stream (Records.hpp:204-210) never needs an
                   O(T) reduction on the sweep path
    """

    counts: jax.Array
    ever_boundary: jax.Array
    n_records: jax.Array
    n_boundaries: jax.Array

    @staticmethod
    def create(T: int, K: int) -> "RecordBuffers":
        if K * T >= 2**31:
            # z * T + start would wrap negative and mode="drop" would then
            # silently discard marginal scatters; fail loudly instead. The
            # position-sharded engine indexes per shard (K * T_local), so
            # this bound only limits single-device runs.
            raise ValueError(
                f"marginal buffer K*T = {K}*{T} exceeds int32 indexing; "
                "shard the position axis (parallel.make_sharded_engine)"
            )
        return RecordBuffers(
            counts=jnp.zeros((K * T,), dtype=jnp.int32),
            ever_boundary=jnp.zeros((T,), dtype=bool),
            n_records=jnp.zeros((), dtype=jnp.int32),
            n_boundaries=jnp.zeros((), dtype=jnp.int32),
        )


class SweepOutputs(NamedTuple):
    """Per-sweep results needed by the host-side output layer."""

    states: jax.Array  # (Bcap,) int32 per-block states
    sizes: jax.Array  # (Bcap,) int32 block sizes (0 = padding)
    n_blocks: jax.Array  # () int32
    threshold: jax.Array  # () float32 compression threshold used


def accumulate_sweep_stats(
    states: jax.Array,
    sizes: jax.Array,
    n_blocks: jax.Array,
    block_stats_t: jax.Array,
    mapping: jax.Array,
    nr_params: int,
) -> SweepStats:
    """Segment-reduce the sampled path into conjugate-update statistics
    (reference pass 3, ForwardBackward.hpp:170-212).
    ``block_stats_t`` is the (dim, 2, B) block-axis-minor layout
    (ops.blocks.block_sufficient_stats_t).

    Implemented as one-hot mask reductions (products over the block axis)
    instead of segment_sum: each statistic is a dense (K, B) or (P, B)
    reduction with no scatter, so its cost is O(K * B) regardless of how
    blocks fall into states (no colliding updates to a K-sized target).
    Every product runs at HIGHEST precision (see _HIGHEST)."""
    B = states.shape[0]
    K = mapping.shape[0]
    valid = jnp.arange(B) < n_blocks
    sizes_f = sizes.astype(jnp.float32) * valid

    oh = (
        states[None, :] == jnp.arange(K, dtype=states.dtype)[:, None]
    ).astype(jnp.float32)  # (K, B)
    oh_valid = oh * valid[None, :].astype(jnp.float32)

    state_counts = jnp.dot(oh, sizes_f, precision=_HIGHEST)  # (K,), masked

    # transitions: diagonal self-transitions (N-1 per block) plus one
    # prev->cur count per block, prev of the first block being state 0
    diag = jnp.dot(
        oh, (sizes.astype(jnp.float32) - 1.0) * valid, precision=_HIGHEST
    )
    prev = jnp.concatenate([jnp.zeros((1,), dtype=states.dtype), states[:-1]])
    oh_prev = (
        prev[None, :] == jnp.arange(K, dtype=states.dtype)[:, None]
    ).astype(jnp.float32)
    pairs = jnp.einsum(
        "ib,jb->ij", oh_prev * valid[None, :], oh,
        preferred_element_type=jnp.float32, precision=_HIGHEST,
    )
    trans_counts = pairs + jnp.diag(diag)

    # theta statistics: route each (block, dim) stat to its emission param
    dim = mapping.shape[1]
    pm = mapping[states]  # (B, dim) int32 — gather from a tiny table
    theta_sums = jnp.zeros((nr_params,), jnp.float32)
    theta_sumsqs = jnp.zeros((nr_params,), jnp.float32)
    theta_counts = jnp.zeros((nr_params,), jnp.float32)
    validf = valid.astype(jnp.float32)
    for d in range(dim):
        ohp = (
            pm[:, d][None, :] == jnp.arange(nr_params, dtype=pm.dtype)[:, None]
        ).astype(jnp.float32) * validf[None, :]  # (P, B)
        theta_sums = theta_sums + jnp.dot(
            ohp, block_stats_t[d, 0], precision=_HIGHEST
        )
        theta_sumsqs = theta_sumsqs + jnp.dot(
            ohp, block_stats_t[d, 1], precision=_HIGHEST
        )
        theta_counts = theta_counts + jnp.dot(ohp, sizes_f, precision=_HIGHEST)
    return SweepStats(theta_sums, theta_sumsqs, theta_counts, trans_counts, state_counts)


def position_states(
    states: jax.Array, starts: jax.Array, n_blocks: jax.Array, T: int
) -> jax.Array:
    """Expand per-block states to per-position states. (T,) int32."""
    B = states.shape[0]
    valid = jnp.arange(B) < n_blocks
    marks = jnp.zeros((T,), dtype=jnp.int32).at[starts].add(
        valid.astype(jnp.int32), mode="drop"
    )
    block_id = jnp.cumsum(marks) - 1
    return states[block_id]


def record_sweep(
    buffers: RecordBuffers,
    states: jax.Array,
    starts: jax.Array,
    n_blocks: jax.Array,
    enabled=True,
) -> RecordBuffers:
    """Fold one recorded sweep into the marginal buffers.

    O(#blocks), not O(T): block b in state z contributes +1 at (z, starts[b])
    and -1 at (z, starts[b+1]) — the latter written as a decrement with the
    *previous* block's state at every block start. Padded starts carry the T
    sentinel and are dropped. State-change boundaries (= the reference's
    marginal segment refinement) are exactly the block starts whose state
    differs from the previous block's.

    ``enabled`` (scalar bool) masks the whole update by pushing every index
    out of bounds — recording runs unconditionally in recording phases and
    is predicated here instead of under ``lax.cond`` (a cond around the
    update interacted pathologically with the scanned sweep, costing far
    more per recorded sweep than the masked scatters). Phases
    that never record (thinning 0) skip this entirely via the STATIC
    ``record`` flag on the sweep/phase programs.

    NOTE: flat indices are int32; valid while K * T < 2^31 (position-sharded
    engines index per shard, so this binds only single-device runs)."""
    T = buffers.ever_boundary.shape[0]
    B = states.shape[0]
    valid = (jnp.arange(B) < n_blocks) & enabled
    prev = jnp.concatenate([jnp.zeros((1,), states.dtype), states[:-1]])
    oob = jnp.int32(buffers.counts.shape[0])
    inc = jnp.where(valid, states * T + starts, oob)
    dec_ok = valid & (starts > 0)
    dec = jnp.where(dec_ok, prev * T + starts, oob)
    B_ones = jnp.ones((B,), jnp.int32)
    flat = buffers.counts.at[jnp.concatenate([inc, dec])].add(
        jnp.concatenate([B_ones, -B_ones]), mode="drop"
    )
    chg = dec_ok & (states != prev)
    # count newly-created boundaries BEFORE setting them (O(#blocks) gather;
    # keeps the segments stream off any O(T) reduction)
    was_set = jnp.where(
        chg, buffers.ever_boundary[jnp.minimum(starts, T - 1)], True
    )
    newly = jnp.sum((chg & ~was_set).astype(jnp.int32))
    everb = buffers.ever_boundary.at[jnp.where(chg, starts, T)].set(
        True, mode="drop"
    )
    return RecordBuffers(
        counts=flat,
        ever_boundary=everb,
        n_records=buffers.n_records + jnp.where(enabled, 1, 0),
        n_boundaries=buffers.n_boundaries + newly,
    )


def _sweep_core(
    key,
    model: HMMState,
    priors: HMMPriors,
    ranked: RankedWeights,
    cand_pos,  # (capacity+1,) pre-sorted bucket candidates (+ T sentinel)
    cand_rank,  # (capacity,)
    prefix: PrefixStats,
    buffers: RecordBuffers,
    do_record,
    use_dynamic,
    static_threshold,
    *,
    method: str,
    capacity: int,
    spec_nr_params: int,
    mapping: jax.Array,
    use_self_transitions: bool,
    cell_bits: int = 16,
    record: bool = True,
    debug: bool = False,
):
    """Shared sweep body used by both the per-sweep and the scanned phase
    entry points. ``record`` is STATIC: non-recording phases compile
    without the marginal-update scatters; STATIC ``debug`` compiles in the
    invariant bitmask (hammlet_tpu.debug) at zero cost when off."""
    T = ranked.pos_by_rank.shape[0]
    thr = jnp.where(use_dynamic, model.threshold(T), static_threshold)
    blocks = make_blocks_bucketed(cand_pos, cand_rank, ranked, thr)
    # (dim, 2, B) block-axis-minor layout: every per-block array keeps the
    # long block axis contiguous (ops.blocks.block_sufficient_stats_t)
    bstats = block_sufficient_stats_t(prefix, blocks, cell_bits)

    k_states, k_model = jax.random.split(key)
    if method == "F":
        states = fb_sample_states(
            k_states, bstats, blocks.sizes, blocks.n_blocks,
            model.theta_mean, model.theta_var, model.A, model.pi,
            mapping, use_self_transitions,
        )
    elif method == "M":
        states = mixture_sample_states(
            k_states, bstats, blocks.sizes, blocks.n_blocks,
            model.theta_mean, model.theta_var, mapping,
        )
    else:  # pragma: no cover
        raise ValueError(f"unknown sampling method {method!r}")

    stats = accumulate_sweep_stats(
        states, blocks.sizes, blocks.n_blocks, bstats, mapping, spec_nr_params
    )
    new_model = resample_model(k_model, priors, stats)

    ok = blocks.n_blocks <= capacity
    if record:
        new_buffers = record_sweep(
            buffers, states, blocks.starts, blocks.n_blocks,
            enabled=jnp.logical_and(do_record, ok),
        )
    else:
        new_buffers = buffers
    outputs = SweepOutputs(states, blocks.sizes, blocks.n_blocks, thr)
    if debug:
        from hammlet_tpu.debug import model_error_bits

        # the INPUT model is what the sweep sampled from — a poisoned
        # parameter must fail this sweep even though the conjugate resample
        # would produce a finite model again (the reference guards every
        # parameter setter, Observation.hpp:374-392)
        err = model_error_bits(model, bstats) | model_error_bits(new_model)
    else:
        err = jnp.int32(0)
    return new_model, new_buffers, outputs, err


@functools.partial(
    jax.jit,
    static_argnames=("method", "capacity", "spec_nr_params", "mapping_tuple",
                     "use_self_transitions", "n_iters", "thinning",
                     "cell_bits", "record", "want_blocks", "debug"),
    donate_argnames=("buffers",),
)
def gibbs_phase(
    master_key: jax.Array,
    model: HMMState,
    priors: HMMPriors,
    ranked: RankedWeights,
    cand_pos: jax.Array,
    cand_rank: jax.Array,
    prefix: PrefixStats,
    buffers: RecordBuffers,
    counter,  # () int32 — chunk key = fold_in(master_key, counter)
    use_dynamic,
    static_threshold,
    *,
    method: str,
    capacity: int,
    spec_nr_params: int,
    mapping_tuple: tuple,
    use_self_transitions: bool,
    n_iters: int,
    thinning: int = 0,  # STATIC; > 0 requires n_iters % thinning == 0
    cell_bits: int = 16,
    record: bool = True,
    want_blocks: bool = False,
    debug: bool = False,
):
    """n_iters Gibbs sweeps as one on-device program.

    Everything the driver needs per chunk comes out of this ONE program —
    including the pre-chunk snapshot of the record buffers (``prev``, for
    overflow replay) and the packed overflow diagnostics ``diag`` =
    [max n_blocks, last n_blocks, error bits], so the driver syncs exactly
    once per chunk (on ``diag``) and issues no eager op in between.

    ``thinning`` is STATIC and the chunk is structured as
    n_iters/thinning macro-steps of (thinning-1) QUIET sweeps compiled
    WITHOUT the recording scatters plus one RECORDING sweep: a masked-out
    scatter still executes (its indices are merely pushed out of bounds),
    so the split is structural, not a runtime mask, and a quiet sweep pays
    no recording work. The driver aligns chunk boundaries to thinning
    multiples.

    Per-sweep RNG keys are fold_in(fold_in(master, counter), i) with i the
    within-chunk sweep index, so the driver can replay an identical chunk
    at a larger capacity after an overflow by passing the same counter.

    Returns (model, buffers, prev, diag, rec_nbs, rec_means, rec_vars,
    blk): the rec_* stacks hold one row PER RECORDED SWEEP (n_iters rows
    when thinning == 0/1 or record is off — then they are the per-sweep
    stacks); ``blk`` stacks (states, n_boundaries) per recorded sweep when
    STATIC ``want_blocks`` — states travel in the smallest dtype that fits
    K, and block SIZES are not shipped at all: the driver reconstructs them
    exactly from the static candidate arrays and the per-sweep block count
    (a sweep's boundary set is ``cand_pos[cand_rank < n_blocks]`` by
    construction, make_blocks_bucketed), ~8x less device-to-host traffic
    than shipping int32 states and sizes. ``prev`` is None when
    ``record`` is static-False. Streams drain once per chunk instead of
    once per sweep (the reference records per sweep, Records.hpp:155-235;
    here a per-sweep transfer would be a host sync inside the phase)."""
    mapping = jnp.asarray(np.asarray(mapping_tuple, dtype=np.int32))
    key = jax.random.fold_in(master_key, counter)
    prev = buffers if record else None
    K = len(mapping_tuple)
    state_dtype = jnp.int8 if K <= 127 else jnp.int16 if K <= 32767 else jnp.int32

    def body(rec: bool):
        def b(carry, i):
            model, buffers = carry
            k = jax.random.fold_in(key, i)
            new_model, new_buffers, outputs, err = _sweep_core(
                k, model, priors, ranked, cand_pos, cand_rank, prefix,
                buffers, jnp.bool_(rec), use_dynamic, static_threshold,
                method=method, capacity=capacity,
                spec_nr_params=spec_nr_params, mapping=mapping,
                use_self_transitions=use_self_transitions,
                cell_bits=cell_bits, record=record and rec, debug=debug,
            )
            ys = (
                outputs.n_blocks, new_model.theta_mean,
                new_model.theta_var, err,
            )
            if rec and want_blocks:
                ys = ys + (
                    outputs.states.astype(state_dtype),
                    new_buffers.n_boundaries,
                )
            return (new_model, new_buffers), ys

        return b

    if not record or thinning <= 1:
        # uniform chunk: every sweep records (thinning == 1) or none does
        rec = record and thinning == 1
        (model, buffers), ys = jax.lax.scan(
            body(rec), (model, buffers), jnp.arange(n_iters)
        )
        nbs, means, varis, errs = ys[:4]
        rec_nbs, rec_means, rec_varis = nbs, means, varis
        blk = ys[4:] if (rec and want_blocks) else None
        max_nb, last_nb, max_err = jnp.max(nbs), nbs[-1], jnp.max(errs)
    else:
        if n_iters % thinning:
            raise ValueError("n_iters must be a multiple of static thinning")
        n_macro = n_iters // thinning

        def macro(carry, m):
            i0 = m * thinning
            carry, qys = jax.lax.scan(
                body(False), carry, i0 + jnp.arange(thinning - 1)
            )
            carry, rys = body(True)(carry, i0 + thinning - 1)
            return carry, (qys, rys)

        (model, buffers), (qys, rys) = jax.lax.scan(
            macro, (model, buffers), jnp.arange(n_macro)
        )
        rec_nbs, rec_means, rec_varis = rys[:3]
        blk = rys[4:] if want_blocks else None
        max_nb = jnp.maximum(jnp.max(qys[0]), jnp.max(rec_nbs))
        last_nb = rec_nbs[-1]
        max_err = jnp.maximum(jnp.max(qys[3]), jnp.max(rys[3]))
    diag = jnp.stack([max_nb, last_nb, max_err]).astype(jnp.int32)
    return model, buffers, prev, diag, rec_nbs, rec_means, rec_varis, blk


@functools.partial(
    jax.jit,
    static_argnames=("method", "capacity", "spec_nr_params", "mapping_tuple",
                     "use_self_transitions", "cell_bits", "record", "debug"),
    donate_argnames=("buffers",),
)
def gibbs_sweep(
    key: jax.Array,
    model: HMMState,
    priors: HMMPriors,
    ranked: RankedWeights,
    cand_pos: jax.Array,
    cand_rank: jax.Array,
    prefix: PrefixStats,
    buffers: RecordBuffers,
    do_record: jax.Array,  # () bool
    use_dynamic: jax.Array,  # () bool
    static_threshold: jax.Array,  # () float32
    *,
    method: str,  # "F" (forward-backward) or "M" (mixture)
    capacity: int,
    spec_nr_params: int,
    mapping_tuple: tuple,
    use_self_transitions: bool,
    cell_bits: int = 16,
    record: bool = True,
    debug: bool = False,
) -> tuple[HMMState, RecordBuffers, SweepOutputs]:
    """One full Gibbs iteration (HMM.hpp:99-121)."""
    mapping = jnp.asarray(np.asarray(mapping_tuple, dtype=np.int32))
    return _sweep_core(
        key, model, priors, ranked, cand_pos, cand_rank, prefix, buffers, do_record,
        use_dynamic, static_threshold,
        method=method, capacity=capacity, spec_nr_params=spec_nr_params,
        mapping=mapping, use_self_transitions=use_self_transitions,
        cell_bits=cell_bits, record=record, debug=debug,
    )[:3]
