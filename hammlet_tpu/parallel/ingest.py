"""Bounded-memory sharded ingest for the position-sharded engine.

The reference streams its ingest in one pass with O(dim * log T) extra
memory (src/wavelet.hpp:98-188); the previous sharded path here materialized
float64 (T, dim, 2) monoliths on the host (~48 GB at 3 Gbp). This module
rebuilds the same arrays SHARD BY SHARD, so peak host memory is
O(T_local * dim) regardless of T, and each finished piece is placed directly
on its device. Nothing global ever exists on the host except O(T / 2^cell)
per-cell summaries.

The Haar maxlet transform and breakpoint weights decompose exactly across
cell-aligned shards (T_local is a multiple of the cell size 2^c):

- maxlet levels 1..c are shard-local (every merge span lies inside one
  shard); the level-c partial sums are exactly the per-cell dyadic totals,
  so levels > c run once on the tiny (n_cells, dim) array of gathered cell
  totals and write coefficients only at cell-start positions.
- breakpoint-weight propagation at intervals >= 2^c touches only cell-start
  positions, so it runs on the subsampled (n_cells,) array (the index/guard
  arithmetic is scale-invariant: ceilPow2(T)/2^c == ceilPow2(ceil(T/2^c))).
  Sub-cell intervals touch cell interiors plus one max-contribution per
  level into the NEXT shard's first position — a single scalar halo per
  shard, applied after the local pass (cell-start values never propagate
  further down, they only accumulate maxima).

Both facts make every per-position output bit-identical to the monolithic
kernels in ops/wavelet.py (tested in tests/test_sharded_ingest.py).

The prefix-sum cells (ops/blocks.py convention) are likewise built per
shard: float64 in-cell reverse cumsums rounded to float32 once, per-cell
float64 totals kept for the exact cross-cell prefix. The auto-prior block
means (AutoPriors.hpp:86-107) accumulate streaming across shards with a
(sum, count) carry for the block spanning a shard edge.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from hammlet_tpu.parallel.mesh import POS_AXIS

F32 = np.float32
INF = np.float32(np.inf)
_SQRT2HALF = np.float32(np.float32(np.sqrt(np.float64(2.0))) / np.float32(2.0))


def _ceil_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _local_maxlet(data: np.ndarray, cell_bits: int):
    """Maxlet levels 1..cell_bits for one shard slice (bit-exact float32,
    reference pairwise-dyadic order, src/wavelet.hpp:131-173).

    Returns (coeffs, cell_sums): coeffs (L,) float32 with +inf at positions
    this pass does not own (cell starts and incomplete spans); cell_sums
    (floor(L / 2^cell_bits), dim) float32 level-c dyadic partial sums of the
    complete cells."""
    data = np.asarray(data, dtype=F32)
    if data.ndim == 1:
        data = data[:, None]
    L, dim = data.shape
    coeffs = np.full(L, INF, dtype=F32)
    sums = data.copy()
    level = 1
    normalizer = _SQRT2HALF
    while sums.shape[0] >= 2 and level <= cell_bits:
        n_pairs = sums.shape[0] // 2
        left = sums[0 : 2 * n_pairs : 2]
        right = sums[1 : 2 * n_pairs : 2]
        detail = np.max(
            np.float32(normalizer) * np.abs(left - right), axis=1
        ).astype(F32)
        idx = (np.arange(n_pairs) << level) + (1 << (level - 1))
        coeffs[idx] = detail
        sums = (left + right).astype(F32)
        level += 1
        normalizer = F32(normalizer * _SQRT2HALF)
    n_cells_full = L >> cell_bits
    if sums.shape[0] > n_cells_full:
        sums = sums[:n_cells_full]
    elif sums.shape[0] < n_cells_full:  # pragma: no cover - cannot happen
        raise AssertionError("lost complete cells in local maxlet")
    return coeffs, sums


def _top_maxlet(cell_sums: np.ndarray, n_cells: int, cell_bits: int) -> np.ndarray:
    """Maxlet levels > cell_bits on the complete-cell dyadic totals.

    Returns (n_cells,) float32: the coefficient value at each cell-START
    position (cell index k -> position k * 2^cell_bits); +inf where the
    global transform leaves +inf (cell 0, incomplete spans)."""
    cw = np.full(n_cells, INF, dtype=F32)
    # normalizer chain continues from the local passes: global level
    # cell_bits + l uses (1/sqrt2)^(cell_bits + l) via repeated f32 mult
    normalizer = _SQRT2HALF
    for _ in range(cell_bits):
        normalizer = F32(normalizer * _SQRT2HALF)
    sums = np.asarray(cell_sums, dtype=F32)
    level = 1  # in cell units
    while sums.shape[0] >= 2:
        n_pairs = sums.shape[0] // 2
        left = sums[0 : 2 * n_pairs : 2]
        right = sums[1 : 2 * n_pairs : 2]
        detail = np.max(
            np.float32(normalizer) * np.abs(left - right), axis=1
        ).astype(F32)
        idx = (np.arange(n_pairs) << level) + (1 << (level - 1))
        cw[idx] = detail
        sums = (left + right).astype(F32)
        level += 1
        normalizer = F32(normalizer * _SQRT2HALF)
    return cw


def _cell_weights(cell_coeffs: np.ndarray, T: int, cell_bits: int) -> np.ndarray:
    """Breakpoint-weight propagation at intervals >= 2^cell_bits, run on the
    subsampled cell-start array (wavelet.hpp:78-92 with T -> ceil(T/2^c);
    the in-range guard (2k+2)*I < T is invariant under the rescale because
    every compared index is a multiple of 2^c)."""
    w = np.asarray(cell_coeffs, dtype=F32).copy()
    size = len(w)
    interval = _ceil_pow2(size) // 2
    while interval >= 1:
        idx = np.arange(interval, size, 2 * interval)
        if idx.size:
            m = w[idx]
            Lp = idx - interval
            Rp = idx + interval
            ok = Rp < size
            tgt = Rp[ok]
            w[tgt] = np.maximum(w[tgt], m[ok])
            bad = ~ok
            w[Lp[bad]] = INF
            w[idx[bad]] = INF
            w[Lp] = np.maximum(w[Lp], w[idx])
        interval //= 2
    return w


def _local_weight_pass(
    w: np.ndarray, shard_start: int, T: int, cell_bits: int
) -> float:
    """Sub-cell breakpoint-weight propagation for one shard slice, in place.

    ``w`` holds the shard's local coefficients with its cell-start entries
    already replaced by the final cell-level weights. All max-accumulations
    commute (inf absorbs), so running levels vectorized matches the
    reference's in-place sequential order exactly. Returns the halo: the
    max contribution this shard propagates into the NEXT shard's first
    position (right-edge writes landing exactly at the shard end)."""
    L = len(w)
    halo = -np.inf
    interval = min(1 << max(cell_bits - 1, 0), _ceil_pow2(max(T, 1)) // 2)
    if cell_bits == 0:
        return halo
    while interval >= 1:
        idx = np.arange(interval, L, 2 * interval)
        if idx.size:
            m = w[idx]
            Lp = idx - interval
            Rp = idx + interval
            cond = (shard_start + Rp) < T
            in_arr = cond & (Rp < L)
            tgt = Rp[in_arr]
            w[tgt] = np.maximum(w[tgt], m[in_arr])
            to_halo = cond & (Rp == L)
            if to_halo.any():
                halo = max(halo, float(m[to_halo][0]))
            bad = ~cond
            w[Lp[bad]] = INF
            w[idx[bad]] = INF
            w[Lp] = np.maximum(w[Lp], w[idx])
        interval //= 2
    return halo


def _cell_prefix(data: np.ndarray, T_local: int, cell_bits: int):
    """Per-shard prefix pieces (ops/blocks.py cell convention): float32
    in-cell reverse cumsums of (x, x^2) accumulated in float64, plus the
    float64 per-cell totals for the exact cross-cell prefix.

    Returns (r_local (T_local, dim, 2) f32, cell_tot (cells, dim, 2) f64)
    for the slice padded with zeros to T_local."""
    cell = 1 << cell_bits
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[:, None]
    L, dim = data.shape
    n_cells = T_local >> cell_bits
    r = np.zeros((T_local, dim, 2), dtype=np.float32)
    cell_tot = np.zeros((n_cells, dim, 2), dtype=np.float64)
    for c in range(n_cells):
        lo = c * cell
        if lo >= L:
            break
        hi = min(lo + cell, L)
        # float64 exists only one cell at a time (a full-shard f64 copy
        # would add 8 B/pos of host transient on top of the f32 slice)
        seg = data[lo:hi].astype(np.float64)
        st = np.stack([seg, seg * seg], axis=-1)  # (n, dim, 2) float64
        rc = np.cumsum(st[::-1], axis=0)[::-1]
        r[lo:hi] = rc.astype(np.float32)
        cell_tot[c] = rc[0]
    return r, cell_tot


def _gather_shard_payloads(mesh, payloads: dict[int, np.ndarray]) -> np.ndarray:
    """All-gather equal-shaped per-shard host payloads to every process.

    ``payloads`` maps shard index -> array for each shard whose device is
    process-local. Returns the (n_shards, *payload_shape) array, identical
    on every process. float64 payloads travel bit-exactly as int32 views
    (device buffers are float32-only without x64). Single-process
    this is one device round-trip of O(n_shards * payload) bytes."""
    devices = mesh.devices.reshape(-1)
    sample = next(iter(payloads.values()))
    shape = sample.shape
    if sample.dtype == np.float64:
        view = {j: np.ascontiguousarray(p).view(np.int32) for j, p in payloads.items()}
        out = _gather_shard_payloads(mesh, view)
        return out.view(np.float64).reshape((len(devices),) + shape)
    pieces = [
        jax.device_put(payloads[j], d)
        for j, d in enumerate(devices)
        if d.process_index == jax.process_index()
    ]
    sharded = NamedSharding(mesh, P(POS_AXIS))
    x = jax.make_array_from_single_device_arrays(
        (len(devices) * shape[0],) + shape[1:], sharded, pieces
    )
    rep = jax.jit(lambda v: v, out_shardings=NamedSharding(mesh, P()))(x)
    return np.asarray(rep).reshape((len(devices),) + shape)


@dataclass
class ShardedIngest:
    """Device-resident sharded ingest products (bounded host memory)."""

    negw: jax.Array  # (T_pad,) sharded: per-shard ascending sort of -weights
    rank: jax.Array  # (T_pad,) sharded: per-shard weight-rank -> local pos
    r: jax.Array  # (P*dim*2, T_local+1) sharded: per-shard local R in the
    #               position-axis-minor layout (rows = (d, c) components,
    #               incl. the right-edge entry at column T_local)
    q2_hi: jax.Array  # (n_cells_pad + 1, dim, 2) replicated
    q2_lo: jax.Array
    noise_std: float
    nb0: int  # boundary count at the universal threshold
    block_means: np.ndarray  # (3,) f64 moments of the thr0 block means:
    #                          [sum m, sum m^2, count] over (block, dim)
    T: int
    dim: int
    T_local: int
    cell_bits: int


def sharded_ingest(
    mesh,
    data: np.ndarray | Callable[[int, int], np.ndarray],
    T: int | None = None,
    dim: int | None = None,
    *,
    T_local: int,
    cell_bits: int,
    weight_multiplier: float = 1.0,
) -> ShardedIngest:
    """Shard-by-shard ingest: maxlet + breakpoint weights + prefix cells +
    noise estimate + auto-prior block means, never holding more than one
    shard of intermediates on the host.

    ``data`` is either the full (T, dim) float32 array (sliced by view, no
    copy) or a provider ``f(start, stop) -> (stop-start, dim) array`` (pass
    T and dim explicitly) so multi-terabase inputs stream from disk.
    """
    if callable(data):
        if T is None or dim is None:
            raise ValueError("T and dim are required with a data provider")
        provider = data
    else:
        arr = np.asarray(data, dtype=np.float32)
        if arr.ndim == 1:
            arr = arr[:, None]
        T, dim = arr.shape

        def provider(start: int, stop: int) -> np.ndarray:
            return arr[start:stop]

    cell = 1 << cell_bits
    if T_local % cell:
        raise ValueError("T_local must be a multiple of the cell size")
    devices = mesh.devices.reshape(-1)
    n_shards = len(devices)
    if n_shards * T_local < T:
        raise ValueError("T_local * n_shards must cover T")
    n_cells_pad = (n_shards * T_local) >> cell_bits
    n_cells = -(-T // cell)
    cells_per_shard = T_local >> cell_bits
    proc = jax.process_index()
    local = [j for j, d in enumerate(devices) if d.process_index == proc]

    # ---- pass 1: local maxlet + prefix cells, one local shard at a time --
    # every process touches only its own shards' data; the per-shard
    # summaries exchanged below are O(T / 2^cell_bits) — bytes per megabase
    coeffs_parts: dict[int, np.ndarray] = {}
    pay1: dict[int, np.ndarray] = {}  # [cell_tot | dyadic | odd_sum, odd_cnt]
    r_pieces: list[jax.Array] = []
    pay1_len = cells_per_shard * dim * 2 + cells_per_shard * dim + 2
    for j in local:
        start = j * T_local
        stop = min(start + T_local, T)
        payload = np.zeros(pay1_len, dtype=np.float64)
        piece = np.zeros((T_local + 1, dim, 2), dtype=np.float32)
        if start < T:
            d = provider(start, stop)
            coeffs, csums = _local_maxlet(d, cell_bits)
            coeffs_parts[j] = coeffs
            # dyadic level-c sums (exact as float64) for the top levels
            dy = np.zeros((cells_per_shard, dim), dtype=np.float64)
            dy[: len(csums)] = csums
            # noise partials: odd local == odd global (T_local is even);
            # every odd position < T has a finite level-1 coefficient
            odd = coeffs[1::2]
            r_loc, ct = _cell_prefix(d, T_local, cell_bits)
            o = cells_per_shard * dim * 2
            payload[:o] = ct.ravel()
            payload[o : o + cells_per_shard * dim] = dy.ravel()
            payload[-2] = float(odd.astype(np.float64).sum())
            payload[-1] = float(len(odd))
            piece[:T_local] = r_loc
            # extra right-edge row: R[shard_end] = full total of the next
            # shard's first cell (0 past the data)
            nstart = (j + 1) * T_local
            if nstart < T:
                nd = np.asarray(
                    provider(nstart, min(nstart + cell, T)), dtype=np.float64
                )
                if nd.ndim == 1:
                    nd = nd[:, None]
                piece[T_local, :, 0] = nd.sum(axis=0).astype(np.float32)
                piece[T_local, :, 1] = (nd * nd).sum(axis=0).astype(np.float32)
            del d, r_loc
        else:
            coeffs_parts[j] = np.zeros(0, dtype=F32)
        pay1[j] = payload
        # position-axis-minor contiguous component rows (the per-sweep
        # gathers then read long rows; see ops.blocks.PrefixStats.r_t)
        r_pieces.append(
            jax.device_put(
                np.ascontiguousarray(
                    piece.transpose(1, 2, 0).reshape(dim * 2, T_local + 1)
                ),
                devices[j],
            )
        )

    gathered = _gather_shard_payloads(mesh, pay1)  # (P, pay1_len) f64
    o = cells_per_shard * dim * 2
    cell_tot = gathered[:, :o].reshape(n_cells_pad, dim, 2)
    dyadic_all = gathered[:, o : o + cells_per_shard * dim].reshape(
        n_cells_pad, dim
    )
    odd_sum = float(gathered[:, -2].sum())
    odd_cnt = int(gathered[:, -1].sum())
    noise = (odd_sum / max(odd_cnt, 1)) / float(
        0.797884560802865355879892119868763736951717262329869315331
    )

    # ---- global cell-level structures (O(T / 2^c), tiny; replicated) -----
    q2 = np.zeros((n_cells_pad + 1, dim, 2), dtype=np.float64)
    np.cumsum(cell_tot, axis=0, out=q2[:n_cells_pad])
    q2[n_cells_pad] = q2[n_cells_pad - 1]
    q2_hi_h = q2.astype(np.float32)
    q2_lo_h = (q2 - q2_hi_h.astype(np.float64)).astype(np.float32)

    n_full_cells = T >> cell_bits
    dyadic = dyadic_all[:n_full_cells].astype(np.float32)
    cell_coeffs = _top_maxlet(dyadic, n_cells, cell_bits)
    cw = _cell_weights(cell_coeffs, T, cell_bits)

    # ---- pass 2a: local sub-cell weight propagation + halo exchange ------
    thr = np.float32(np.sqrt(2.0 * np.log(float(T))) * noise)
    halos: dict[int, np.ndarray] = {}
    for j in local:
        w = coeffs_parts[j]
        L = len(w)
        halo_out = -np.inf
        if L:
            cws = cw[j * cells_per_shard : j * cells_per_shard + (-(-L // cell))]
            w[::cell][: len(cws)] = cws
            halo_out = _local_weight_pass(w, j * T_local, T, cell_bits)
        halos[j] = np.array([halo_out], dtype=np.float64)
    halos_all = _gather_shard_payloads(mesh, halos)[:, 0]  # (P,)

    # ---- pass 2b: ranking + streaming auto-prior block statistics --------
    negw_pieces: list[jax.Array] = []
    rank_pieces: list[jax.Array] = []
    # per-shard summary: [n_starts, head_cnt, tail_cnt, inner_n,
    #                     inner_sum_m, inner_sum_m2, head_sum*, tail_sum*]
    summaries: dict[int, np.ndarray] = {}
    for j in local:
        start = j * T_local
        stop = min(start + T_local, T)
        w = coeffs_parts[j]
        L = len(w)
        summ = np.zeros(6 + 2 * dim, dtype=np.float64)
        if L:
            halo_prev = halos_all[j - 1] if j > 0 else -np.inf
            w[0] = np.maximum(w[0], np.float32(halo_prev))
            if weight_multiplier != 1.0:
                w = w * np.float32(weight_multiplier)
            starts_loc = np.flatnonzero(w >= thr)
            ns = len(starts_loc)
            summ[0] = ns
            # stream the shard in bounded chunks (a full-shard float64 view
            # would transiently double the per-shard host footprint — at
            # 3 Gbp / 16 processes that is ~1.5 GB per host); the open
            # block's (sum, count) carries across chunk edges
            CHUNK = 1 << 21
            cur = np.zeros(dim, dtype=np.float64)
            cur_cnt = 0
            inner_n = inner_s = inner_s2 = 0.0
            head_done = False
            si = 0
            for off in range(0, L, CHUNK):
                hi = min(off + CHUNK, L)
                dc = np.asarray(
                    provider(start + off, start + hi), dtype=np.float64
                )
                if dc.ndim == 1:
                    dc = dc[:, None]
                sj = np.searchsorted(starts_loc, hi, side="left")
                sl = starts_loc[si:sj] - off
                if sl.size == 0:
                    cur += dc.sum(axis=0)
                    cur_cnt += hi - off
                    continue
                first = int(sl[0])
                cur += dc[:first].sum(axis=0)
                cur_cnt += first
                if not head_done:
                    # cur_cnt == global index of the first start: the head
                    # partial block joining the previous shard's tail
                    summ[1] = cur_cnt
                    summ[6 : 6 + dim] = cur
                    head_done = True
                elif cur_cnt > 0:
                    m = cur / cur_cnt  # inner block closed at this start
                    inner_n += dim
                    inner_s += m.sum()
                    inner_s2 += (m * m).sum()
                sums = np.add.reduceat(dc, sl, axis=0)
                sizes = np.diff(np.concatenate([sl, [hi - off]]))
                if len(sl) > 1:
                    m = sums[:-1] / sizes[:-1, None]  # inner complete blocks
                    inner_n += m.size
                    inner_s += m.sum()
                    inner_s2 += (m * m).sum()
                cur = sums[-1].astype(np.float64, copy=True)
                cur_cnt = int(sizes[-1])
                si = sj
            if ns == 0:
                summ[1] = L  # whole shard joins the spanning block
                summ[6 : 6 + dim] = cur
            else:
                summ[2] = cur_cnt
                summ[3] = inner_n
                summ[4] = inner_s
                summ[5] = inner_s2
                summ[6 + dim :] = cur
        summaries[j] = summ
        wfull = np.full(T_local, -INF, dtype=F32)
        wfull[:L] = w
        order = np.argsort(-wfull, kind="stable")
        negw_pieces.append(
            jax.device_put((-wfull[order]).astype(np.float32), devices[j])
        )
        rank_pieces.append(jax.device_put(order.astype(np.int32), devices[j]))
        del coeffs_parts[j]

    summ_all = _gather_shard_payloads(mesh, summaries)  # (P, 6 + 2*dim)

    # stitch the per-shard pieces into global block-mean moments (the block
    # spanning a shard edge combines the left tail with following heads;
    # identical on every process)
    nb0 = int(summ_all[:, 0].sum())
    carry_sum = np.zeros(dim, dtype=np.float64)
    carry_cnt = 0.0
    S = S2 = N = 0.0

    def _close(carry_sum, carry_cnt, S, S2, N):
        if carry_cnt > 0:
            m = carry_sum / carry_cnt
            S += m.sum()
            S2 += (m * m).sum()
            N += dim
        return S, S2, N

    for j in range(n_shards):
        ns, head_cnt, tail_cnt, inner_n, inner_s, inner_s2 = summ_all[j, :6]
        head_sum = summ_all[j, 6 : 6 + dim]
        tail_sum = summ_all[j, 6 + dim :]
        carry_sum = carry_sum + head_sum
        carry_cnt += head_cnt
        if ns > 0:
            S, S2, N = _close(carry_sum, carry_cnt, S, S2, N)
            S += inner_s
            S2 += inner_s2
            N += inner_n
            carry_sum = tail_sum.copy()
            carry_cnt = tail_cnt
    S, S2, N = _close(carry_sum, carry_cnt, S, S2, N)
    block_means = np.array([S, S2, N], dtype=np.float64)

    # ---- assemble global sharded arrays -----------------------------------
    T_pad = n_shards * T_local
    shard = NamedSharding(mesh, P(POS_AXIS))
    rep = NamedSharding(mesh, P())
    negw = jax.make_array_from_single_device_arrays(
        (T_pad,), shard, negw_pieces
    )
    rank = jax.make_array_from_single_device_arrays(
        (T_pad,), shard, rank_pieces
    )
    r = jax.make_array_from_single_device_arrays(
        (n_shards * dim * 2, T_local + 1), shard, r_pieces
    )
    q2_hi = jax.device_put(jnp.asarray(q2_hi_h), rep)
    q2_lo = jax.device_put(jnp.asarray(q2_lo_h), rep)

    return ShardedIngest(
        negw=negw,
        rank=rank,
        r=r,
        q2_hi=q2_hi,
        q2_lo=q2_lo,
        noise_std=float(noise),
        nb0=int(nb0),
        block_means=block_means,
        T=T,
        dim=dim,
        T_local=T_local,
        cell_bits=cell_bits,
    )
