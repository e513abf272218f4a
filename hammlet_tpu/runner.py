"""End-to-end engine: ingest -> auto-priors -> sampling-scheme execution.

Replaces the reference's main() pipeline (src/main.cpp:23-477): the streaming
ingest + transform, the noise estimate, auto-priors, and the ``-i``
sampling-scheme interpreter (tokens ``P``, ``S``, ``D``, ``{F,M} iter thin``,
main.cpp:391-454) driving the fused on-device Gibbs sweep.

Dynamic block counts are handled with a static capacity: every sweep reports
its true block count; if it overflows the capacity the sweep is *replayed*
with the same RNG key at a larger capacity (the sweep is a pure function of
(key, model)), so results are never silently truncated.
"""

from __future__ import annotations

import functools
import os
import time
from dataclasses import dataclass, field

import numpy as np
import jax
import jax.numpy as jnp

from hammlet_tpu.io.records import Records
from hammlet_tpu.models.autopriors import autoprior, autoprior_host, noise_std_estimate
from hammlet_tpu.models.hmm import (
    HMMPriors,
    HMMState,
    ModelSpec,
    sample_from_priors,
    threshold_host,
)
from hammlet_tpu.ops.blocks import (
    DEVICE_CELL_BITS,
    bucket_candidates,
    build_prefix_stats,
    build_prefix_stats_device,
    build_ranked_weights,
    build_ranked_weights_device,
)
from hammlet_tpu.ops.wavelet import breakpoint_weights, maxlet_transform
from hammlet_tpu.samplers.sweep import RecordBuffers, gibbs_phase


def parse_scheme(tokens: list[str]) -> list[tuple]:
    """Parse the ``-i`` scheme into ops:
    ("prior",), ("static",), ("dynamic",), ("run", method, iters, thinning).
    Grammar per main.cpp:367-454."""
    n_num = sum(1 for t in tokens if t not in ("P", "S", "D", "F", "M"))
    n_meth = sum(1 for t in tokens if t in ("F", "M"))
    if n_num != 2 * n_meth:
        raise ValueError(
            'Parameters for -i, excluding "P", "S" and "D", must be multiples of 3!'
        )
    ops: list[tuple] = [("prior",)]  # samplePrior starts true (main.cpp:384)
    i = 0
    while i < len(tokens):
        t = tokens[i]
        if t == "P":
            ops.append(("prior",))
            i += 1
        elif t == "S":
            ops.append(("static",))
            i += 1
        elif t == "D":
            ops.append(("dynamic",))
            i += 1
        elif t in ("F", "M"):
            if i + 2 >= len(tokens):
                raise ValueError("Incomplete command line for -i!")
            ops.append(("run", t, int(tokens[i + 1]), int(tokens[i + 2])))
            i += 3
        else:
            raise ValueError(f"Unknown sampling type {t}!")
    return ops


#: sweeps per compiled scan chunk — phases run as repeats of one compiled
#: program (+ one remainder size) to minimize XLA compiles. Each chunk ends
#: in one host sync (the overflow diagnostics), so longer chunks amortize
#: the per-chunk launch and sync; the cost of a longer chunk is a coarser
#: capacity ladder and bigger overflow replays (both rare after burn-in).
PHASE_CHUNK = int(os.environ.get("HAMMLET_PHASE_CHUNK", 128))

#: hard ceiling on the compiled block capacity (env-overridable). The first
#: post-prior burn-in sweeps genuinely have ~T blocks (the threshold is near
#: zero right after a prior draw — the reference pays the same ~T-block
#: sweeps, HMM.hpp:99-121), but a sweep at capacity ~T allocates O(K*K*cap)
#: transients, so at chromosome-scale T burn-in alone would need many times
#: the post-burn-in working set. Capacity is therefore capped at 2^25
#: (~1.2 GB of FB transients at K=3): a burn-in chunk that overflows the
#: ceiling is ACCEPTED TRUNCATED — the device program already reduces to
#: the top-capacity ranked weights when n_blocks > capacity
#: (make_blocks_bucketed) — which just means those first sweeps run at an
#: effectively higher threshold; the dynamic threshold rises within a few
#: sweeps and exact blocks resume. Recording sweeps are never truncated
#: (their in-graph record predicate masks on overflow, and the driver raises
#: instead of accepting).
_MAX_CAPACITY = int(
    os.environ.get("HAMMLET_MAX_CAPACITY", 0)
) or (1 << 25)


#: an EXPLICIT env chunk length disables the capacity scaling below (tests
#: pin small chunks to exercise per-chunk behavior like checkpoint cadence)
_PHASE_CHUNK_ENV = "HAMMLET_PHASE_CHUNK" in os.environ


@functools.cache
def _scale_chunks() -> bool:
    """Capacity-scaled chunk lengths on accelerator backends: a small-
    capacity sweep is short, so at a fixed chunk length the per-chunk
    launch and host sync would be a large share of the chunk. On the CPU
    backend scaling would only multiply the set of compiled program shapes
    (the CI suite compiles hundreds of programs in one process; the extra
    shapes pushed it over an XLA:CPU compiler resource cliff — reproducible
    late-suite compile-time SIGSEGV/SIGABRT)."""
    if _PHASE_CHUNK_ENV:
        return False
    return jax.default_backend() != "cpu"


def _chunk_for_capacity(capacity: int) -> int:
    """Scan length for one compiled phase chunk at a given block capacity
    (see Engine._max_chunk for what each end of the ladder bounds)."""
    if capacity >= (1 << 23):
        return min(8, PHASE_CHUNK)
    if not _scale_chunks():
        return PHASE_CHUNK
    if capacity <= (1 << 11):
        return 16 * PHASE_CHUNK  # 2048 default
    if capacity <= (1 << 13):
        return 8 * PHASE_CHUNK
    if capacity <= (1 << 15):
        return 4 * PHASE_CHUNK
    if capacity <= (1 << 17):
        return 2 * PHASE_CHUNK
    return PHASE_CHUNK


#: default persistent compile cache: a fixed directory in the checkout
#: (listed in .gitignore), so every process of one checkout shares it
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def compilation_cache_dir(environ=os.environ) -> str:
    """Where the persistent compile cache lives: ``$JAX_COMPILATION_CACHE_DIR``
    exactly when it is set, else DEFAULT_CACHE_DIR."""
    return environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compilation_cache() -> None:
    """Persist XLA compilations across processes (a cold start compiles
    every phase program; the cache turns later starts into loads).

    CPU-backend processes never enable it: XLA:CPU cache entries embed
    AOT machine code for the WRITER's CPU, and a build VM can resume on a
    different physical host — loading a foreign entry logs a 'machine
    feature not supported ... could lead to SIGILL' warning and then
    sporadically segfaults mid-suite (reproduced: the CLI enabling the
    cache in-process poisoned every later in-process compile)."""
    if jax.default_backend() == "cpu":
        return
    jax.config.update("jax_compilation_cache_dir", compilation_cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


def compact_marginals(buffers) -> tuple[np.ndarray, np.ndarray]:
    """RLE-compact the marginal buffers ON DEVICE and download only the
    per-segment rows (crucial over low-bandwidth host links: a 3 Gbp counts
    buffer is GBs, its RLE form is KBs-MBs).

    Returns (starts, seg_counts) as host arrays; segment i covers
    [starts[i], starts[i+1]) (last ends at T); seg_counts is (n_seg, K)."""
    T = buffers.ever_boundary.shape[0]
    K = buffers.counts.shape[0] // T
    n_seg = int(np.asarray(jnp.sum(buffers.ever_boundary))) + 1

    @functools.partial(jax.jit, static_argnames=("n",))
    def gather(diff, everb, n):
        # decode the flat boundary-difference accumulator (one cumsum at
        # save time instead of an O(T) expansion per recorded sweep)
        counts = jnp.cumsum(diff.reshape(K, T), axis=1)
        first = jnp.concatenate([jnp.ones((1,), bool), everb[1:]])
        (starts,) = jnp.nonzero(first, size=n, fill_value=T)
        return starts.astype(jnp.int32), counts[:, starts]

    starts, seg_counts = gather(buffers.counts, buffers.ever_boundary, n_seg)
    return np.asarray(starts), np.asarray(seg_counts).T


def run_scheme_resumable(engine, tokens: list[str]) -> None:
    """Execute a ``-i`` scheme on an engine (single-device or sharded),
    honoring the engine's scheme cursor: ops before ``scheme_op_index`` are
    skipped (their effect lives in the restored model/threshold/RNG state)
    and a partially-completed F/M phase continues at ``scheme_op_done`` with
    the original thinning alignment.

    A checkpoint records which ``-i`` token list its cursor indexes; resuming
    with a different scheme is rejected (the cursor would silently skip or
    truncate the wrong ops)."""
    ckpt_tokens = getattr(engine, "ckpt_scheme_tokens", None)
    if (
        engine.scheme_op_index or engine.scheme_op_done
    ) and ckpt_tokens is not None and list(ckpt_tokens) != list(tokens):
        raise ValueError(
            "checkpoint was taken under -i scheme "
            f"{' '.join(ckpt_tokens)!r} but this run uses "
            f"{' '.join(tokens)!r}; resume with the original scheme"
        )
    if engine.scheme_op_index == 0:
        # a fresh (non-resumed) scheme always starts at sweep 0 of its first
        # op, even if a previous direct run() left a stale scheme_op_done
        engine.scheme_op_done = 0
    engine.ckpt_scheme_tokens = list(tokens)
    for idx, op in enumerate(parse_scheme(tokens)):
        if idx < engine.scheme_op_index:
            continue
        if op[0] == "prior":
            engine.sample_prior()
        elif op[0] == "static":
            engine.set_static()
        elif op[0] == "dynamic":
            engine.set_dynamic()
        else:
            _, method, iters, thin = op
            start = engine.scheme_op_done
            if start < iters:
                engine.run(method, iters - start, thin, start=start)
        engine.scheme_op_index = idx + 1
        engine.scheme_op_done = 0
    # reset the cursor so a subsequent run_scheme() on the same engine
    # executes in full (the cursor only persists across process restarts,
    # via checkpoints taken while a phase is running)
    engine.scheme_op_index = 0
    engine.scheme_op_done = 0


def _next_chunk(done: int, end: int, thinning: int, max_chunk: int):
    """(n, static_thinning, records) for the next compiled chunk.

    Recording phases are split into chunks whose length is a multiple of
    the thinning so the phase program can structure itself as
    quiet-sweeps + one-recording-sweep macros (the record-thinning hits
    land exactly at macro ends). Non-multiples arise only at phase edges:
    a resume mid-thinning-window runs one alignment macro of length
    (thinning - done % thinning), and a phase tail shorter than the
    thinning contains no hits and runs as a quiet chunk."""
    remaining = end - done
    if thinning <= 0:
        return min(max_chunk, remaining), 0, False
    mis = done % thinning
    if mis:
        n_align = thinning - mis
        if n_align <= remaining:
            return n_align, n_align, True
        return remaining, 0, False  # tail: no hits left in this phase
    n_hit = (min(max_chunk, remaining) // thinning) * thinning
    if n_hit:
        return n_hit, thinning, True
    if thinning <= remaining:
        return thinning, thinning, True  # thinning wider than max_chunk
    return remaining, 0, False  # tail: no hits left


def _round_capacity(n: int) -> int:
    """Round a block count up to the next capacity bucket: a ~1.25x
    geometric ladder on multiples of 128 (so the blocked scans engage).
    Per-sweep cost is roughly linear in capacity, so a doubling ladder
    wastes up to 2x compute; a 1.25x ladder wastes <= 25% while the block
    count's post-burn-in stability keeps the set of compiled programs
    small in practice."""
    cap = 128
    while cap < n:
        cap = -(-int(cap * 1.25) // 128) * 128
    return cap


@dataclass
class Ingest:
    """Device-resident preprocessed data."""

    weights: jax.Array  # (T,) float32 breakpoint weights (post multiplier)
    weights_host: np.ndarray | None  # host copy (None for device ingest)
    ranked: object  # RankedWeights — positions pre-sorted by weight
    prefix: object  # PrefixStats
    coeffs_host: np.ndarray | None  # maxlet coefficients (host path only)
    noise_std: float
    T: int
    dim: int
    cell_bits: int = 16

    def count_boundaries(self, threshold: float) -> int:
        if self.weights_host is not None:
            return int((self.weights_host >= np.float32(threshold)).sum())
        return int(
            np.asarray(_count_ge(self.ranked.neg_w_sorted, np.float32(threshold)))
        )


@jax.jit
def _count_ge(neg_sorted: jax.Array, thr: jax.Array) -> jax.Array:
    """Boundary count at a threshold: O(log T) searchsorted as one compiled
    program (eagerly it would dispatch op by op)."""
    return jnp.searchsorted(neg_sorted, -thr, side="right")


def host_transform(data: np.ndarray) -> tuple[np.ndarray, float, np.ndarray]:
    """(coeffs, noise_std, weights) on the host — native C++ when built,
    else the JAX kernels (bit-identical either way)."""
    from hammlet_tpu import native

    if native.available():
        coeffs = native.maxlet(data)
        noise = native.noise_std(coeffs)
        weights = native.breakpoint_weights(coeffs)
    else:
        coeffs_dev = maxlet_transform(jnp.asarray(data))
        coeffs = np.asarray(coeffs_dev)
        noise = noise_std_estimate(coeffs)
        weights = np.asarray(breakpoint_weights(coeffs_dev))
    return coeffs, noise, weights


def ingest(data: np.ndarray, weight_multiplier: float = 1.0) -> Ingest:
    """maxlet transform -> noise estimate -> breakpoint weights -> prefix
    sums (main.cpp:277-344). Runs on the host (one-time O(T)); only the
    final device arrays are uploaded."""
    data = np.asarray(data, dtype=np.float32)
    if data.ndim == 1:
        data = data[:, None]
    T, dim = data.shape
    coeffs_host, noise, weights_host = host_transform(data)
    if weight_multiplier != 1.0:
        weights_host = weights_host * np.float32(weight_multiplier)
    prefix = build_prefix_stats(data)
    return Ingest(
        weights=jnp.asarray(weights_host),
        weights_host=weights_host,
        ranked=build_ranked_weights(weights_host),
        prefix=prefix,
        coeffs_host=coeffs_host,
        noise_std=noise,
        T=T,
        dim=dim,
    )


@jax.jit
def _odd_coeff_mean(coeffs):
    """Mean of the odd-position (finest-level) maxlet coefficients —
    masked full-length reduction (see _ingest_transform_program)."""
    Tc_ = coeffs.shape[0]
    odd = (jax.lax.iota(jnp.int32, Tc_) & 1) == 1
    return jnp.sum(jnp.where(odd, coeffs, 0.0)) / (Tc_ // 2)


@jax.jit
def _scale_weights(w, m):
    return w * m


@functools.partial(jax.jit, static_argnames=("wm",))
def _ingest_transform_program(data, wm: float):
    """Maxlet transform + finest-level noise reduction + breakpoint
    weights + weight ranking (argsort) as ONE compiled program: one compile
    and one dispatch instead of four. The prefix-sum build is a SECOND
    program on purpose: a single fully-fused ingest keeps the transform
    chain and the prefix intermediates live at the same time, which raises
    peak device memory by several T-sized buffers."""
    from hammlet_tpu.ops.blocks import RankedWeights

    coeffs = maxlet_transform(data)
    # noise estimate: float32 reduction on device (the reference accumulates
    # in double — the difference is far below MC noise). Masked full-length
    # reduction over the odd positions keeps every array (T,)-shaped: no
    # (T/2, 2) reshape and no stride-2 slice.
    Tc_ = coeffs.shape[0]
    odd = (jax.lax.iota(jnp.int32, Tc_) & 1) == 1
    odd_mean = jnp.sum(jnp.where(odd, coeffs, 0.0)) / (Tc_ // 2)
    weights = breakpoint_weights(coeffs)
    if wm != 1.0:
        weights = weights * jnp.float32(wm)
    neg = -weights
    order = jnp.argsort(neg, stable=True).astype(jnp.int32)
    ranked = RankedWeights(neg_w_sorted=neg[order], pos_by_rank=order)
    return odd_mean, weights, ranked


@functools.partial(jax.jit, static_argnames=("cell_bits",))
def _ingest_prefix_program(data, cell_bits: int):
    """In-cell reverse prefix sums (build_prefix_stats_device's _incell),
    compiled separately from the transform chain (see above)."""
    T, dim = data.shape
    CELL = 1 << cell_bits
    n_cells = -(-T // CELL)
    Tc = n_cells * CELL
    stats = jnp.stack([data, data * data], axis=-1)  # (T, dim, 2)
    stats = jnp.pad(stats, ((0, Tc - T), (0, 0), (0, 0)))
    x = stats.reshape(n_cells, CELL, dim, 2)
    r = jnp.flip(jnp.cumsum(jnp.flip(x, axis=1), axis=1), axis=1)
    totals = r[:, 0]  # (n_cells, dim, 2)
    r_full = jnp.concatenate(
        [r.reshape(Tc, dim, 2)[:T], jnp.zeros((1, dim, 2), jnp.float32)]
    )
    # position-axis-minor contiguous layout (PrefixStats.r_t)
    return jnp.transpose(r_full, (1, 2, 0)), totals


def ingest_device(data: np.ndarray, weight_multiplier: float = 1.0) -> Ingest:
    """Device-side ingest: upload only the raw data (T*dim*4 bytes) and run
    the transform/sort/prefix construction on the accelerator (the host
    transform is a serial O(T) pass); bit-identical maxlet/weights."""
    data = np.asarray(data, dtype=np.float32)
    if data.ndim == 1:
        data = data[:, None]
    T, dim = data.shape
    data_dev = jnp.asarray(data)
    if T > (1 << 27):
        # very large T: every ingest stage runs as its OWN program, so only
        # one stage's intermediates are live at a time (the fused transform
        # program holds the maxlet levels, the weight pyramid and the sort
        # together); the extra dispatches are negligible at this T
        coeffs = maxlet_transform(data_dev)
        odd_mean = _odd_coeff_mean(coeffs)
        weights = breakpoint_weights(coeffs)
        if weight_multiplier != 1.0:
            weights = _scale_weights(weights, jnp.float32(weight_multiplier))
        ranked = build_ranked_weights_device(weights)
    else:
        odd_mean, weights, ranked = _ingest_transform_program(
            data_dev, float(weight_multiplier)
        )
    r_t, totals = _ingest_prefix_program(data_dev, DEVICE_CELL_BITS)
    noise = float(odd_mean) / 0.7978845608028654
    # tiny host round trip: exact float64 cross-cell prefix from the
    # per-cell totals (n_cells = T / 4096 values)
    n_cells = totals.shape[0]
    tot_host = np.asarray(totals).astype(np.float64)
    q2 = np.zeros((n_cells + 1, dim, 2), dtype=np.float64)
    np.cumsum(tot_host, axis=0, out=q2[:n_cells])
    q2[n_cells] = q2[n_cells - 1]
    q2_hi = q2.astype(np.float32)
    q2_lo = (q2 - q2_hi.astype(np.float64)).astype(np.float32)
    from hammlet_tpu.ops.blocks import PrefixStats

    prefix = PrefixStats(
        r_t=r_t, q2_hi=jnp.asarray(q2_hi), q2_lo=jnp.asarray(q2_lo)
    )
    return Ingest(
        weights=weights,
        weights_host=None,
        ranked=ranked,
        prefix=prefix,
        coeffs_host=None,
        noise_std=noise,
        T=T,
        dim=dim,
        cell_bits=DEVICE_CELL_BITS,
    )


@dataclass
class Engine:
    """Single-device sampling engine (the multi-device engine lives in
    hammlet_tpu.parallel)."""

    ing: Ingest
    spec: ModelSpec
    priors: HMMPriors
    seed: int
    records: Records | None = None
    capacity: int | None = None
    checkpoint_path: str | None = None
    checkpoint_every: int = 0  # sweeps between checkpoints (0 = off)
    max_capacity: int | None = None  # ceiling (None = _MAX_CAPACITY)

    model: HMMState = field(init=False)
    buffers: RecordBuffers = field(init=False)
    sweep_counter: int = field(init=False, default=0)
    sweeps_completed: int = field(init=False, default=0)
    # scheme cursor: (index of the next -i op, sweeps already done within it);
    # checkpointed so a resumed run_scheme() continues exactly where the
    # interrupted one stopped instead of replaying the whole scheme
    scheme_op_index: int = field(init=False, default=0)
    scheme_op_done: int = field(init=False, default=0)
    total_sweeps: float = field(init=False, default=0.0)
    sample_time: float = field(init=False, default=0.0)
    last_n_blocks: int = field(init=False, default=0)

    def __post_init__(self):
        self._key = jax.random.PRNGKey(self.seed)
        self._mapping_tuple = tuple(
            tuple(int(v) for v in row) for row in self.spec.mapping()
        )
        K = self.spec.nr_states
        self.buffers = RecordBuffers.create(self.ing.T, K)
        self.model = sample_from_priors(self._next_key(), self.priors)
        self._dynamic = True
        self._static_threshold = 0.0  # host float: passed per chunk
        # capacity ceiling: explicit capacities above the default ceiling
        # are honored (the caller knows better)
        self.max_capacity = max(
            min(self.ing.T, self.max_capacity or _MAX_CAPACITY),
            self.capacity or 0,
        )
        if self.capacity is None:
            # size for the prior-threshold block structure with headroom
            nb = self.ing.count_boundaries(
                threshold_host(self.model.theta_var, self.ing.T)
            )
            self.capacity = min(
                self.ing.T, self.max_capacity, _round_capacity(2 * nb + 64)
            )

    def _next_key(self) -> jax.Array:
        self.sweep_counter += 1
        return jax.random.fold_in(self._key, self.sweep_counter)

    def _candidates(self):
        """Position-sorted boundary candidates for the current capacity
        (sorted once per capacity change, not per sweep)."""
        if not hasattr(self, "_cands"):
            self._cands = {}
        if self.capacity not in self._cands:
            self._cands[self.capacity] = bucket_candidates(
                self.ing.ranked, self.capacity
            )
        return self._cands[self.capacity]

    def _candidates_host(self, capacity: int):
        """Host copies of the candidate arrays for one capacity (downloaded
        once per capacity change; lets the record drain reconstruct every
        sweep's block sizes without shipping them from the device)."""
        if not hasattr(self, "_cands_h"):
            self._cands_h = {}
        if capacity not in self._cands_h:
            cand_pos, cand_rank = self._cands[capacity]
            self._cands_h[capacity] = (
                np.asarray(cand_pos), np.asarray(cand_rank)
            )
        return self._cands_h[capacity]

    # -- scheme ops -------------------------------------------------------

    def sample_prior(self) -> None:
        self.model = sample_from_priors(self._next_key(), self.priors)

    def set_static(self) -> None:
        self._dynamic = False
        self._static_threshold = float(self.model.threshold(self.ing.T))

    def set_dynamic(self) -> None:
        self._dynamic = True

    def _resize_capacity_for_phase(self) -> None:
        """Re-size the compiled block capacity to the CURRENT threshold's
        boundary count at a phase boundary (both directions).

        The mid-phase ladder only shrinks from measured chunk maxima, so a
        phase entered right after burn-in would otherwise compile its first
        chunk at the stale near-T capacity (the first post-prior sweeps
        genuinely have ~T blocks) — at T=16M a ~13M-capacity FB program,
        whose compile and transients dwarf the settled one's. One O(log T)
        searchsorted against the ranked weights prices the real capacity
        before anything compiles; the overflow replay still grows it if a
        later sweep's threshold drops."""
        thr = (
            self._static_threshold
            if not self._dynamic
            else threshold_host(self.model.theta_var, self.ing.T)
        )
        nb = self.ing.count_boundaries(thr)
        self.capacity = min(
            self.ing.T, self.max_capacity, _round_capacity(nb + nb // 8 + 64)
        )

    def _max_chunk(self) -> int:
        """Compiled-chunk length for the current capacity.

        Huge-capacity programs (the first burn-in chunks run near the
        capacity ceiling: the first post-prior sweeps genuinely have ~T
        blocks) compile as SHORT scans: a long scan at tens of millions of
        blocks multiplies compile time and transient memory, and short
        chunks let the capacity ladder shrink within a few sweeps of
        burn-in instead of paying a full chunk at huge capacity.

        SMALL-capacity programs compile as LONG scans: every chunk ends in
        one launch and one host sync, a fixed cost that a short
        small-capacity chunk cannot amortize. Per-sweep device time is
        ~linear in capacity, so the ladder keeps per-chunk device time
        roughly constant and replay/shrink granularity bounded. (The
        ladder's H100 A/B against a fixed chunk length is not measured
        yet.)"""
        return _chunk_for_capacity(self.capacity)

    def run(
        self, method: str, iterations: int, thinning: int, start: int = 0
    ) -> None:
        """One F/M phase of `iterations` sweeps with record thinning.

        Always runs the fully on-device scanned phase (one dispatch per
        compiled chunk, no per-sweep host syncs); streams that need
        per-sweep block arrays get them stacked inside the scan and drained
        once per chunk. ``start`` offsets the thinning counter when resuming
        a phase whose first ``start`` sweeps already ran (checkpoint
        resume)."""
        if iterations <= 0:
            return
        self._resize_capacity_for_phase()
        import contextlib

        profile_dir = os.environ.get("HAMMLET_PROFILE")
        prof = (
            jax.profiler.trace(profile_dir)
            if profile_dir
            else contextlib.nullcontext()
        )
        t0 = time.time()
        with prof:
            self._run_phase_scanned(method, iterations, thinning, start)
            jax.block_until_ready(self.model.theta_mean)
        self.sample_time += time.time() - t0
        self.total_sweeps += iterations

    def _run_phase_scanned(
        self, method: str, iterations: int, thinning: int, start: int = 0
    ) -> None:
        from hammlet_tpu.debug import debug_enabled, raise_on_error

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
            # chunk selection: recording chunks are aligned to thinning
            # multiples so the compiled program can structurally separate
            # quiet sweeps (no scatters) from recording sweeps — under a
            # runtime record mask every sweep would still execute the
            # (masked-out) scatters
            n, thin_s, rec_s = _next_chunk(
                done, end, thinning if recording else 0, self._max_chunk()
            )
            self.sweep_counter += 1
            counter = self.sweep_counter  # fixed across overflow replays
            while True:
                cand_pos, cand_rank = self._candidates()
                (model, buffers, prev, diag, nbs, means, varis, blk) = gibbs_phase(
                    self._key,
                    self.model,
                    self.priors,
                    self.ing.ranked,
                    cand_pos,
                    cand_rank,
                    self.ing.prefix,
                    self.buffers,
                    np.int32(counter),
                    np.bool_(self._dynamic),
                    np.float32(self._static_threshold),
                    method=method,
                    capacity=self.capacity,
                    spec_nr_params=self.spec.nr_params,
                    mapping_tuple=self._mapping_tuple,
                    use_self_transitions=self.spec.use_self_transitions,
                    n_iters=n,
                    thinning=thin_s,
                    cell_bits=self.ing.cell_bits,
                    record=rec_s,
                    want_blocks=want_blocks and rec_s,
                    debug=debug_enabled(),
                )
                # the previous chunk's record drain runs HERE, between this
                # chunk's async dispatch and its single host sync — the
                # device-to-host fetches and CSV formatting overlap the
                # device compute instead of stalling it
                if pending is not None:
                    self._drain_records(*pending)
                    pending = None
                # the chunk's single host sync: [max_nb, last_nb, err]
                diag_h = np.asarray(diag)
                raise_on_error(int(diag_h[2]))
                max_nb = int(diag_h[0])
                if max_nb <= self.capacity:
                    self.model, self.buffers = model, buffers
                    self.last_n_blocks = int(diag_h[1])
                    break
                # the device-side block count SATURATES at capacity+1 (it
                # counts within the top capacity+1 ranked weights only,
                # make_blocks_bucketed); re-price the true count from the
                # pre-chunk model's threshold so the capacity grows in one
                # jump instead of a 2x-per-replay ladder
                thr_est = (
                    self._static_threshold
                    if not self._dynamic
                    else threshold_host(self.model.theta_var, self.ing.T)
                )
                max_nb = max(max_nb, self.ing.count_boundaries(thr_est))
                grown = min(
                    self.ing.T, self.max_capacity, _round_capacity(2 * max_nb)
                )
                if grown <= self.capacity:
                    # at the capacity ceiling. Burn-in (non-recording) chunks
                    # are accepted TRUNCATED: the device program reduced to
                    # the top-capacity ranked weights (an effectively higher
                    # threshold for those sweeps; see _MAX_CAPACITY). A
                    # recording chunk must be exact — fail with guidance.
                    if rec_s:
                        raise RuntimeError(
                            f"recording sweep needs {max_nb} blocks but the "
                            f"capacity ceiling is {self.capacity} "
                            "(HAMMLET_MAX_CAPACITY); raise the ceiling or "
                            "extend burn-in so the threshold settles first"
                        )
                    self.model, self.buffers = model, buffers
                    self.last_n_blocks = min(int(diag_h[1]), self.capacity)
                    break
                self.capacity = grown
                # replay the chunk (same counter) from the pre-chunk snapshot
                # so recorded sweeps cannot double-record
                self.buffers = prev if prev is not None else buffers
            if self.records is not None and rec_s:
                pending = (
                    nbs, means, varis, blk, n // max(thin_s, 1), self.capacity
                )
            done += n
            self.sweeps_completed += n
            self.scheme_op_done = done
            # the block count drops sharply after burn-in; shrink the
            # compiled capacity to track it (grows back via replay if needed).
            # 12.5% headroom: per-sweep cost is ~linear in capacity, and an
            # occasional overflow replay is cheaper than a permanent rung up
            target = min(
                self.ing.T,
                self.max_capacity,
                _round_capacity(max_nb + max_nb // 8 + 64),
            )
            if target < self.capacity:
                self.capacity = target
            pending = self._maybe_checkpoint(pending)
        if pending is not None:
            self._drain_records(*pending)

    def _drain_records(self, nbs, means, varis, blk, n_hits, capacity) -> None:
        """Drain one chunk's per-recorded-sweep stacks into the record
        streams (only the enabled ones; each np.asarray is one host fetch).

        Block SIZES never travel from the device: a sweep's boundary set is
        exactly ``cand_pos[cand_rank < n_blocks]`` (make_blocks_bucketed),
        and the candidate arrays are static per capacity — so the sizes are
        reconstructed here from the per-sweep block count alone, and the
        device ships only the (R, capacity) sampled states in the smallest
        dtype that fits K (~8x less device-to-host traffic than shipping
        int32 states and sizes)."""
        wants_comp = "compression" in self.records.enabled
        wants_params = "parameters" in self.records.enabled
        want_blocks = blk is not None
        if not (wants_comp or wants_params or want_blocks):
            return
        nbs_h = np.asarray(nbs)
        if want_blocks:
            from hammlet_tpu.parallel.sharded import _reassemble_block_rows

            pos_h, rank_h = self._candidates_host(capacity)
            states_h = np.asarray(blk[0])[:n_hits].astype(np.int32)
            # size reconstruction + compaction in the shared batch routine
            # (native when built) — the P = 1, T_local = T case of the
            # sharded drain; the per-sweep NumPy mask loop this replaces
            # rebuilt an O(capacity) selection per recorded sweep
            states_d, sizes_d, ns_tot = _reassemble_block_rows(
                states_h,
                nbs_h[:n_hits, None].astype(np.int64),
                pos_h[None, :],
                rank_h[None, :],
                self.ing.T,
                self.ing.T,
            )
            # one native batch call formats the whole chunk's CSV bytes
            # (Python per-int formatting here cost more than the device
            # sweeps themselves)
            self.records.record_sweeps_batch(
                states_d,
                sizes_d,
                ns_tot,
                np.asarray(blk[1])[:n_hits],
            )
        elif wants_comp:
            for j in range(n_hits):
                self.records.record_compression(int(nbs_h[j]))
        if wants_params:
            means_h = np.asarray(means)
            varis_h = np.asarray(varis)
            for j in range(n_hits):
                self.records.record_theta(means_h[j], varis_h[j])

    def _maybe_checkpoint(self, pending=None):
        """Checkpoint when due. A due checkpoint first drains the previous
        chunk's pending record payload: the checkpoint counts those sweeps
        as completed, so leaving their stream lines undrained would lose
        them permanently if the process dies right after the save (the
        drain-deferral overlap is kept for every non-checkpoint chunk).
        Returns the (possibly consumed) pending payload."""
        if not self.checkpoint_path or self.checkpoint_every <= 0:
            return pending
        if self.sweeps_completed - getattr(self, "_last_ckpt", 0) >= self.checkpoint_every:
            from hammlet_tpu.checkpoint import save_checkpoint

            if pending is not None:
                self._drain_records(*pending)
                pending = None
            save_checkpoint(self, self.checkpoint_path)
            self._last_ckpt = self.sweeps_completed
        return pending

    def run_scheme(self, tokens: list[str]) -> None:
        run_scheme_resumable(self, tokens)

    def finalize(self) -> None:
        if self.records is not None:
            if "marginals" in self.records.enabled:
                starts, seg_counts = compact_marginals(self.buffers)
                from hammlet_tpu.debug import check_marginal_sums

                # save-time invariant (StateMarginals.hpp:306-308)
                check_marginal_sums(
                    seg_counts, int(np.asarray(self.buffers.n_records))
                )
                self.records.save_marginals_from_segments(
                    starts, seg_counts
                )
            self.records.close()

    # -- metrics / observability ------------------------------------------
    # The reference's only diagnostics are the -O compression/segments
    # streams (Records.hpp:204-210); these are kept, plus first-class
    # throughput counters and an optional on-device profiler trace
    # (set HAMMLET_PROFILE=<dir> to capture a jax.profiler trace per phase).

    @property
    def marginal_counts(self) -> np.ndarray:
        """(K, T) decoded marginal state counts (cumsum of the flat
        boundary-difference accumulator)."""
        T = self.ing.T
        K = self.spec.nr_states
        return np.cumsum(
            np.asarray(self.buffers.counts).reshape(K, T).astype(np.int64),
            axis=1,
        ).astype(np.int32)

    @property
    def sweeps_per_second(self) -> float:
        return self.total_sweeps / max(self.sample_time, 1e-9)

    def metrics(self) -> dict:
        """Structured per-run metrics (SURVEY.md §5 observability)."""
        sps = self.sweeps_per_second
        return {
            "sweeps": self.sweeps_completed,
            "sweeps_per_second": sps,
            "positions_per_second": sps * self.ing.T,
            "compression_ratio": (
                self.ing.T / self.last_n_blocks if self.last_n_blocks else None
            ),
            "block_capacity": self.capacity,
            "recorded_sweeps": int(np.asarray(self.buffers.n_records)),
        }


def make_engine(
    data: np.ndarray,
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
    capacity: int | None = None,
    device_ingest: bool | None = None,
) -> Engine:
    """Build a ready-to-run engine with auto-priors (the only prior mode the
    reference implements, main.cpp:204-215)."""
    import sys

    t0 = time.time()
    trace = (
        (lambda m: print(
            f"[setup +{time.time() - t0:.1f}s] {m}", file=sys.stderr, flush=True
        ))
        if os.environ.get("HAMMLET_SETUP_TRACE")
        else (lambda m: None)
    )
    if device_ingest is None:
        device_ingest = np.asarray(data).size >= 2_000_000
    ing = (
        ingest_device(data, weight_multiplier)
        if device_ingest
        else ingest(data, weight_multiplier)
    )
    trace(f"ingest done (device={device_ingest})")
    spec = ModelSpec(nr_params, nr_data_dim, use_self_transitions)
    if ing.weights_host is not None:
        nig_row = autoprior_host(s2, p, data, ing.weights_host, ing.noise_std)
    else:
        thr0 = float(np.sqrt(2 * np.log(float(ing.T))) * ing.noise_std)
        ap_cap = max(8, ing.count_boundaries(thr0) + 8)
        nig_row = autoprior(
            s2, p, ing.ranked, ing.prefix, ing.noise_std, ap_cap,
            cell_bits=ing.cell_bits,
        )
    trace("autoprior done")
    nig = np.tile(nig_row, (nr_params, 1))
    priors = HMMPriors.create(
        nig, spec.nr_states, trans, self_trans, initial_alpha
    )
    eng = Engine(
        ing=ing,
        spec=spec,
        priors=priors,
        seed=seed,
        records=records,
        capacity=capacity,
    )
    trace(f"engine init done (capacity={eng.capacity})")
    return eng
