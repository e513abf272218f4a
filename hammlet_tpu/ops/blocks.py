"""Dynamic block compression: boundary extraction + O(1) block statistics.

The reference iterates blocks serially with a monotonic-stack pointer array
(src/Blocks/BreakpointArray.hpp:130-235) and queries block sufficient
statistics from a cell-structured Kahan prefix-sum array
(src/Statistics/IntegralArray.hpp:102-124). Here both become fixed-shape
vector ops:

- a block starts at every position t with weight[t] >= threshold
  (w[0] = inf); boundaries are extracted with a fixed-capacity ``nonzero``.
- block sufficient statistics come from two gathers into precomputed
  prefix-sum arrays, decomposed into cells of 2^16 positions to bound float32
  error exactly like the reference's CELLSIZE scheme:
      sum[x, start:end) = R[start] - R[end] + Q2[end >> 16] - Q2[start >> 16]
  where R[i] is the float32 in-cell reverse cumulative sum (accumulated in
  float64 at ingest, rounded once) and Q2[c] is the inclusive cross-cell
  prefix held as a float32 (hi, lo) pair so cell-count differences keep
  ~float64 accuracy.

All shapes are static: boundaries are padded with T (empty blocks of size 0)
up to a caller-chosen capacity, so XLA compiles the sweep once.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

CELL_BITS = 16
CELL = 1 << CELL_BITS


class PrefixStats(NamedTuple):
    """Cell-structured prefix sums of per-position sufficient statistics.

    r_t:    (dim, 2, T+1) float32 — in-cell reverse cumsum of (x, x^2)
            with the POSITION AXIS MINOR and each (d, c) component a
            contiguous row; r_t[d, c, i] = sum over [i, cell_end(i)) of
            the stat, r_t[..., T] handles end-of-data queries. The
            position-major (T+1, dim, 2) layout put a 2 in the minor dim
            and made the per-sweep block-stat gathers stride-2 reads.
    q2_hi:  (n_cells+1, dim, 2) float32 — inclusive cross-cell prefix (hi).
    q2_lo:  (n_cells+1, dim, 2) float32 — residual (lo) of the same.
    """

    r_t: jax.Array
    q2_hi: jax.Array
    q2_lo: jax.Array

    @property
    def r(self) -> jax.Array:
        """(T+1, dim, 2) compatibility view (tests/inspection only — the
        hot path reads the contiguous r_t rows)."""
        return jnp.transpose(self.r_t, (2, 0, 1))

    @property
    def T(self) -> int:
        return self.r_t.shape[2] - 1

    @property
    def dim(self) -> int:
        return self.r_t.shape[0]


def build_prefix_stats(data: np.ndarray, cell_bits: int = CELL_BITS) -> PrefixStats:
    """Host-side ingest: build PrefixStats from raw data (T,) or (T, dim).

    Accumulation runs in float64 and is rounded to float32 once, which
    dominates the accuracy of the reference's float32 Kahan cells.
    ``cell_bits`` sets the cell size (2**cell_bits); it must match the value
    passed to ``block_sufficient_stats``.
    """
    CELL = 1 << cell_bits
    data = np.asarray(data, dtype=np.float64)
    if data.ndim == 1:
        data = data[:, None]
    T, dim = data.shape
    stats = np.stack([data, data * data], axis=-1)  # (T, dim, 2)
    n_cells = (T + CELL - 1) // CELL

    r = np.zeros((T + 1, dim, 2), dtype=np.float64)
    cell_tot = np.zeros((n_cells, dim, 2), dtype=np.float64)
    for c in range(n_cells):
        lo, hi = c * CELL, min((c + 1) * CELL, T)
        seg = stats[lo:hi]
        rc = np.cumsum(seg[::-1], axis=0)[::-1]  # reverse cumsum within cell
        r[lo:hi] = rc
        cell_tot[c] = rc[0]
    # r[T] = 0 (query at end-of-data)

    # inclusive cell prefix: q2[c] = sum of cells 0..c, with the final entry
    # duplicated so c(end)=n_cells (end == T at a cell boundary) works
    q2 = np.zeros((n_cells + 1, dim, 2), dtype=np.float64)
    np.cumsum(cell_tot, axis=0, out=q2[:n_cells])
    q2[n_cells] = q2[n_cells - 1]
    q2_hi = q2.astype(np.float32)
    q2_lo = (q2 - q2_hi.astype(np.float64)).astype(np.float32)

    return PrefixStats(
        r_t=jnp.asarray(
            np.ascontiguousarray(r.astype(np.float32).transpose(1, 2, 0))
        ),
        q2_hi=jnp.asarray(q2_hi),
        q2_lo=jnp.asarray(q2_lo),
    )


#: cell size for the on-device prefix build: small enough that plain float32
#: in-cell cumsums stay well below the reference's Kahan-cell error
DEVICE_CELL_BITS = 12


def build_prefix_stats_device(data: jax.Array, cell_bits: int = DEVICE_CELL_BITS) -> PrefixStats:
    """On-device PrefixStats from device-resident data (T, dim) float32.

    The in-cell reverse cumsums run in float32 over 2^cell_bits elements
    (small cells bound the error); the tiny per-cell totals round-trip
    through the host for an exact float64 cross-cell prefix.
    """
    CELL = 1 << cell_bits
    T, dim = data.shape
    n_cells = -(-T // CELL)
    Tc = n_cells * CELL

    @jax.jit
    def _incell(data):
        stats = jnp.stack([data, data * data], axis=-1)  # (T, dim, 2)
        stats = jnp.pad(stats, ((0, Tc - T), (0, 0), (0, 0)))
        x = stats.reshape(n_cells, CELL, dim, 2)
        r = jnp.flip(jnp.cumsum(jnp.flip(x, axis=1), axis=1), axis=1)
        totals = r[:, 0]  # (n_cells, dim, 2)
        r_full = jnp.concatenate(
            [r.reshape(Tc, dim, 2)[: T], jnp.zeros((1, dim, 2), jnp.float32)]
        )
        return jnp.transpose(r_full, (1, 2, 0)), totals

    r_t, totals = _incell(data)
    tot_host = np.asarray(totals).astype(np.float64)
    q2 = np.zeros((n_cells + 1, dim, 2), dtype=np.float64)
    np.cumsum(tot_host, axis=0, out=q2[:n_cells])
    q2[n_cells] = q2[n_cells - 1]
    q2_hi = q2.astype(np.float32)
    q2_lo = (q2 - q2_hi.astype(np.float64)).astype(np.float32)
    return PrefixStats(r_t=r_t, q2_hi=jnp.asarray(q2_hi), q2_lo=jnp.asarray(q2_lo))


@jax.jit
def build_ranked_weights_device(weights: jax.Array) -> "RankedWeights":
    """On-device RankedWeights (device argsort; no host transfer)."""
    neg = -weights
    order = jnp.argsort(neg, stable=True).astype(jnp.int32)
    return RankedWeights(neg_w_sorted=neg[order], pos_by_rank=order)


class BlockStructure(NamedTuple):
    """Fixed-capacity block decomposition of [0, T).

    starts: (Bcap,) int32 — block start positions, padded with T
    ends:   (Bcap,) int32 — block end positions (exclusive), padded with T
    sizes:  (Bcap,) int32 — block sizes, 0 for padding
    n_blocks: () int32    — number of real blocks
    """

    starts: jax.Array
    ends: jax.Array
    sizes: jax.Array
    n_blocks: jax.Array

    @property
    def capacity(self) -> int:
        return self.starts.shape[0]


def make_blocks(weights: jax.Array, threshold: jax.Array, capacity: int) -> BlockStructure:
    """Threshold the breakpoint weights into a padded block structure.

    Block boundaries are bit-identical to the reference's iterator for the
    same float32 threshold: a block ends at the next position with
    weight >= threshold (BreakpointArray.hpp:224-231).
    """
    T = weights.shape[0]
    mask = weights >= threshold  # mask[0] is always True (w[0] = inf)
    n_blocks = jnp.sum(mask, dtype=jnp.int32)
    (starts,) = jnp.nonzero(mask, size=capacity, fill_value=T)
    starts = starts.astype(jnp.int32)
    ends = jnp.concatenate([starts[1:], jnp.full((1,), T, dtype=jnp.int32)])
    return BlockStructure(starts, ends, ends - starts, n_blocks)


class RankedWeights(NamedTuple):
    """Positions pre-sorted by breakpoint weight (descending), built once at
    ingest. Turns per-sweep block extraction from O(T) masking into an
    O(log T) count + O(capacity log capacity) sort — independent of T.

    neg_w_sorted: (T,) float32 — ascending sort of -weights
    pos_by_rank:  (T,) int32   — position of the rank-r largest weight;
                  ties broken by position (stable), which cannot affect the
                  boundary set (all ties enter together)
    T: () int32 marker is implicit via array length
    """

    neg_w_sorted: jax.Array
    pos_by_rank: jax.Array


def build_ranked_weights(weights: np.ndarray) -> RankedWeights:
    w = np.asarray(weights, dtype=np.float32)
    order = np.argsort(-w, kind="stable")
    return RankedWeights(
        neg_w_sorted=jnp.asarray((-w[order]).astype(np.float32)),
        pos_by_rank=jnp.asarray(order.astype(np.int32)),
    )


def make_blocks_ranked(
    ranked: RankedWeights, threshold: jax.Array, capacity: int
) -> BlockStructure:
    """Identical block structure to ``make_blocks`` but in O(capacity)
    per-sweep work: boundary count via binary search on the sorted weights,
    boundary positions = sort of the top-count ranked positions."""
    T = ranked.pos_by_rank.shape[0]
    n_blocks = jnp.searchsorted(
        ranked.neg_w_sorted, -threshold, side="right"
    ).astype(jnp.int32)
    cand = ranked.pos_by_rank[:capacity]
    starts = jnp.where(jnp.arange(capacity) < n_blocks, cand, T)
    starts = jnp.sort(starts).astype(jnp.int32)
    ends = jnp.concatenate([starts[1:], jnp.full((1,), T, dtype=jnp.int32)])
    return BlockStructure(starts, ends, ends - starts, n_blocks)


def block_sufficient_stats(
    prefix: PrefixStats, blocks: BlockStructure, cell_bits: int = CELL_BITS
) -> jax.Array:
    """(Bcap, dim, 2) float32 — per-block (sum x, sum x^2) per dim.

    Relies on the block-structure convention ends[b] == starts[b+1] (with
    ends[-1] == T and padded starts == T), which every builder in this
    module satisfies: the end-point gathers are then one-row shifts of the
    start-point gathers, halving the gather count (gathers of ~30k random
    rows dominate this function). Padded blocks yield exact zeros
    (start == end == T; r[T] = 0 and the cell terms cancel).
    """
    return jnp.transpose(
        block_sufficient_stats_t(prefix, blocks, cell_bits), (2, 0, 1)
    )


#: static capacity above which the block-stat query uses per-component 1-D
#: gathers instead of the fused minor-axis form (see the function body)
_BS_FUSED_MAX_CAP = 1 << 23


def block_sufficient_stats_t(
    prefix: PrefixStats, blocks: BlockStructure, cell_bits: int = CELL_BITS
) -> jax.Array:
    """(dim, 2, Bcap) float32 — block (sum x, sum x^2) with the BLOCK AXIS
    MINOR. Identical values to ``block_sufficient_stats`` (same gathers,
    same add order per component).

    The block axis is minor so every result row is long and contiguous
    (the (B, dim, 2) layout puts a size-2 axis minor). TWO minor-axis
    gathers (one into r_t, one into the stacked hi/lo cell prefixes)
    produce the whole result: inside a scanned sweep each gather is a
    separate kernel with its own fixed cost, so the op COUNT matters as
    much as the bytes (a per-component 1-D formulation issues 12 gathers;
    which form is faster on the H100 is not measured yet)."""
    s = blocks.starts
    cs = (s >> cell_bits).astype(jnp.int32)
    ce_last = prefix.T >> cell_bits  # cell index of the final end (= T)
    if s.shape[0] > _BS_FUSED_MAX_CAP:
        # near-T burn-in capacities: per-component 1-D gathers bound the
        # live gather result to one (B,) row at a time instead of a
        # (2, dim, 2, B) stack, and their per-op overhead is irrelevant in
        # these rare compute-dominated programs
        dim = prefix.dim
        comps = []
        for d in range(dim):
            for c in range(2):
                r1 = prefix.r_t[d, c]
                qh = prefix.q2_hi[:, d, c]
                ql = prefix.q2_lo[:, d, c]
                r_s1 = r1[s]
                r_e1 = jnp.concatenate([r_s1[1:], jnp.zeros_like(r_s1[:1])])
                qh_s = qh[cs]
                ql_s = ql[cs]
                qh_e = jnp.concatenate([qh_s[1:], qh[ce_last][None]])
                ql_e = jnp.concatenate([ql_s[1:], ql[ce_last][None]])
                comps.append((r_s1 - r_e1) + ((qh_e - qh_s) + (ql_e - ql_s)))
        return jnp.stack(comps).reshape(dim, 2, s.shape[0])
    r_s = prefix.r_t[:, :, s]  # (dim, 2, B)
    # r[ends[b]] = r[starts[b+1]]; r[ends[-1]] = r[T] = 0
    r_e = jnp.concatenate(
        [r_s[:, :, 1:], jnp.zeros_like(r_s[:, :, :1])], axis=2
    )
    # (2, dim, 2, n_cells+1) hi/lo stack — tiny and loop-invariant
    q2c = jnp.stack(
        [
            jnp.transpose(prefix.q2_hi, (1, 2, 0)),
            jnp.transpose(prefix.q2_lo, (1, 2, 0)),
        ]
    )
    q_s = q2c[:, :, :, cs]  # (2, dim, 2, B)
    q_e = jnp.concatenate(
        [q_s[..., 1:], q2c[:, :, :, ce_last][..., None]], axis=3
    )
    qd = q_e - q_s
    return (r_s - r_e) + (qd[0] + qd[1])


def blocks_from_sizes(sizes, capacity: int | None = None) -> BlockStructure:
    """Static block structure from an explicit size list (the reference's
    Blocks<Fixed>, src/Blocks/FixedBlocks.hpp:5-106; Splittable refinement is
    obtained by passing a refined size list). Padded to ``capacity``."""
    sizes = np.asarray(sizes, dtype=np.int64)
    if (sizes <= 0).any():
        raise ValueError("block sizes must be positive")
    T = int(sizes.sum())
    n = len(sizes)
    capacity = n if capacity is None else capacity
    if capacity < n:
        raise ValueError("capacity smaller than number of blocks")
    starts = np.full(capacity, T, dtype=np.int32)
    ends = np.full(capacity, T, dtype=np.int32)
    csum = np.concatenate([[0], np.cumsum(sizes)])
    starts[:n] = csum[:-1]
    ends[:n] = csum[1:]
    return BlockStructure(
        jnp.asarray(starts),
        jnp.asarray(ends),
        jnp.asarray(ends - starts),
        jnp.int32(n),
    )


def split_block_sizes(sizes, index: int, s: int) -> list:
    """Split block ``index`` so its tail piece has size ``s`` — the
    reference's Blocks<Splittable>::split (src/Blocks/SplittableBlocks.hpp:
    53-67: sizes[i] -= s and a new block of size s after it). The refined
    list feeds ``blocks_from_sizes`` for a static structure. Raises if the
    block is not larger than ``s`` (same guard as the reference)."""
    sizes = list(int(v) for v in sizes)
    if sizes[index] <= s:
        raise ValueError("Cannot split block into this size!")
    return sizes[:index] + [sizes[index] - s, s] + sizes[index + 1 :]


@functools.partial(jax.jit, static_argnames=("capacity",))
def bucket_candidates(ranked: RankedWeights, capacity: int):
    """Position-sorted boundary candidates for a capacity bucket.

    The top-``capacity`` ranks are a static set per bucket, so their
    position-sort happens ONCE per capacity change instead of every sweep
    (a sort is the costliest op of the block extraction; the per-sweep work
    drops to a masked compaction).

    Returns (cand_pos, cand_rank): cand_pos ascending positions with a
    sentinel T appended; cand_rank[i] = weight rank of cand_pos[i].
    """
    T = ranked.pos_by_rank.shape[0]
    prefix = ranked.pos_by_rank[:capacity]
    order = jnp.argsort(prefix)
    cand_pos = jnp.concatenate(
        [prefix[order], jnp.full((1,), T, dtype=jnp.int32)]
    )
    return cand_pos, order.astype(jnp.int32)


def make_blocks_bucketed(
    cand_pos: jax.Array,
    cand_rank: jax.Array,
    ranked: RankedWeights,
    threshold: jax.Array,
) -> BlockStructure:
    """Block structure from pre-sorted bucket candidates — no per-sweep sort.

    Identical to make_blocks_ranked for any threshold whose boundary count
    fits the bucket (otherwise n_blocks > capacity flags the overflow).
    Compaction of the valid candidates is an explicit cumsum + scatter
    (jnp.nonzero can lower to a sort, an O(B log B) op per sweep).

    The boundary count is a SATURATING masked count over the top
    capacity+1 ranked weights instead of a binary search over all T: one
    vectorized compare+reduce (a searchsorted lowers to a ~log2(T)-step
    sequential gather loop — tens of dependent small ops per sweep).
    Exact whenever the sweep fits the capacity (the only case whose count
    is ever used: overflowing chunks are replayed or, during burn-in at
    the capacity ceiling, truncated — and the replay driver re-prices the
    true count host-side, runner.Engine._run_phase_scanned). The slice of
    the sorted weights is loop-invariant and hoisted out of the sweep
    scan by XLA."""
    T = ranked.pos_by_rank.shape[0]
    capacity = cand_rank.shape[0]
    neg_head = jax.lax.slice(
        ranked.neg_w_sorted, (0,), (min(capacity + 1, T),)
    )
    n_blocks = jnp.sum(neg_head <= -threshold, dtype=jnp.int32)
    valid = cand_rank < n_blocks
    csum = jnp.cumsum(valid.astype(jnp.int32))
    sel = jnp.full((capacity,), capacity, jnp.int32)
    sel = sel.at[jnp.where(valid, csum - 1, capacity)].set(
        jnp.arange(capacity, dtype=jnp.int32), mode="drop"
    )
    starts = cand_pos[sel]  # padded entries hit the T sentinel
    ends = jnp.concatenate([starts[1:], jnp.full((1,), T, dtype=jnp.int32)])
    return BlockStructure(starts, ends, ends - starts, n_blocks)
