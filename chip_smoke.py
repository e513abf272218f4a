#!/usr/bin/env python3
"""Smoke test of the main path on an NVIDIA GPU.

Drives the engine end to end on the card through the entry points a user
calls (``runner.ingest_device``, ``hammlet_tpu.cli.main``, ``make_engine`` +
``run_scheme``) on the bench's WGS-like synthetic (3 states at 0 and +-2
sigma, 500-position segments) and checks every result with the repo's own
references:

  a  device: GPU platform, card name and power limit, native library build
  b  ingest parity at T = 4M: device ingest vs the native host transform
  c  sweep-statistics parity: one settled sweep's statistics and emission
     log-weights vs a float64 NumPy recomputation (fails under TF32)
  d  main path: the CLI on the 4M file; marginal sums and MAP accuracy
  e  determinism: phase d again with the same seed, byte-identical outputs
  f  GPU vs CPU: the same engine on both backends at T = 200k

Options (each runs only its own phase, after the device checks):
  --full-chromosome  g: BASELINE config 3 at T = 250M on one card
  --four             h: -D 4 on the 4M file vs one card, and -M over four
                     1M-position files vs a sequential run (four cards)

Data and outputs live in .smoke/seed<N>/ next to this file, made from
--seed. Every finding is one line naming the card and its power limit; the
last line is {"ok": true, "device": {...}}. When JAX finds no GPU, or any
phase fails, the script exits non-zero and prints no such line.

Usage: python chip_smoke.py [--seed N] [--full-chromosome | --four]
"""

from __future__ import annotations

import argparse
import functools
import itertools
import json
import shutil
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
MEANS = np.array([0.0, 2.0, -2.0])
SEGLEN = 500
T_MAIN = 4_000_000
T_CROSS = 200_000
T_CHROM = 250_000_000
T_MULTI = 1_000_000
CLI_SCHEME = ["M", "64", "0", "F", "512", "4"]
CHROM_SCHEME = ["M", "64", "0", "F", "100", "4"]
STREAMS = ["marginals", "parameters", "segments"]
MAP_MIN = 0.98  # MAP agreement with the synthetic truth
MARGINAL_MAX_DIFF = 0.06  # mean |freq difference| bound of tests/test_sharded.py


def recorded(scheme: list[str]) -> int:
    """Recorded sweeps of a plain ``{F,M} iters thin`` scheme."""
    return sum(
        int(n) // int(t)
        for _, n, t in zip(scheme[::3], scheme[1::3], scheme[2::3])
        if int(t) > 0
    )


def wgs_synthetic(T: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(data float32 (T,), truth int8 (T,)): CNV segments of SEGLEN
    positions, state s at mean MEANS[s] with unit noise."""
    rng = np.random.default_rng(seed)
    n_seg = -(-T // SEGLEN)
    truth = np.repeat(rng.integers(0, 3, n_seg).astype(np.int8), SEGLEN)[:T]
    data = MEANS[truth].astype(np.float32)
    for lo in range(0, T, 1 << 24):  # bounded float64 temporaries
        hi = min(T, lo + (1 << 24))
        data[lo:hi] += rng.normal(0, 1, hi - lo).astype(np.float32)
    return data, truth


def write_csv(path: Path, data: np.ndarray) -> None:
    with open(path, "w") as fh:
        for i in range(0, len(data), 1_000_000):
            fh.write("\n".join(f"{v:.5f}" for v in data[i : i + 1_000_000]))
            fh.write("\n")


def best_permutation(a_labels, b_labels, k: int = 3) -> tuple[float, tuple]:
    """Highest share of positions where perm[a] == b, over permutations."""
    conf = np.bincount(
        np.asarray(a_labels, np.int64) * k + b_labels, minlength=k * k
    ).reshape(k, k)
    best = max(
        itertools.permutations(range(k)),
        key=lambda p: sum(conf[i, p[i]] for i in range(k)),
    )
    return sum(conf[i, best[i]] for i in range(k)) / len(a_labels), best


def read_marginals(path: Path, T: int, k: int = 3) -> tuple[np.ndarray, np.ndarray]:
    """(sizes, counts (rows, k)) of a marginals CSV; trailing all-zero state
    columns, which the writer trims, come back as zeros."""
    rows = [line.split("\t") for line in path.read_text().splitlines()]
    sizes = np.array([int(r[0]) for r in rows], np.int64)
    counts = np.zeros((len(rows), k), np.int64)
    for i, r in enumerate(rows):
        counts[i, : len(r) - 1] = [int(c) for c in r[1:]]
    if sizes.sum() != T:
        raise AssertionError(f"{path.name}: segment sizes sum to {sizes.sum()}, not {T}")
    return sizes, counts


def check_marginals(path: Path, truth: np.ndarray, n_rec: int) -> tuple[str, np.ndarray]:
    """Every position's counts sum to n_rec; MAP vs truth >= MAP_MIN.
    Returns (summary, per-position frequencies (T, 3))."""
    sizes, counts = read_marginals(path, len(truth))
    bad = np.flatnonzero(counts.sum(axis=1) != n_rec)
    if len(bad):
        raise AssertionError(
            f"{path.name}: {len(bad)} segments do not sum to {n_rec} recorded sweeps"
        )
    map_pos = np.repeat(np.argmax(counts, axis=1), sizes)
    agree, _ = best_permutation(map_pos, truth)
    if agree < MAP_MIN:
        raise AssertionError(f"{path.name}: MAP agrees with truth on {agree:.4f} < {MAP_MIN}")
    freq = np.repeat(counts / n_rec, sizes, axis=0)
    return f"sums {n_rec} at every position, MAP agreement {agree:.5f}", freq


def marginal_distance(fa: np.ndarray, fb: np.ndarray) -> float:
    """Mean |fa - fb[:, perm]| under the best state permutation."""
    return min(
        float(np.mean(np.abs(fa - fb[:, list(p)])))
        for p in itertools.permutations(range(fa.shape[1]))
    )


class Context:
    """Shared state of one run: card label, data paths, results of earlier
    phases that later ones compare with."""

    def __init__(self, seed: int):
        self.seed = seed
        self.dir = REPO / ".smoke" / f"seed{seed}"
        self.out = self.dir / "out"
        shutil.rmtree(self.out, ignore_errors=True)
        self.out.mkdir(parents=True)
        self.results: dict = {}
        self.counter = CompileCounter()

    @functools.cached_property
    def wgs_main(self):
        """(data as the CLI parses it, truth, csv path) at T_MAIN."""
        return self.dataset("wgs4M", T_MAIN, self.seed)

    def dataset(self, name: str, T: int, seed: int):
        from hammlet_tpu.io.input import read_values

        path = self.dir / f"{name}.csv"
        truth_path = self.dir / f"{name}.truth.npy"
        if not (path.exists() and truth_path.exists()):
            data, truth = wgs_synthetic(T, seed)
            write_csv(path, data)
            np.save(truth_path, truth)
        return read_values([str(path)])[:, 0], np.load(truth_path), path


class CompileCounter:
    """Counts XLA backend compiles (JAX's monitoring event)."""

    EVENT = "/jax/core/compile/backend_compile_duration"

    def __init__(self):
        import jax

        self.n = 0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **kwargs):
        if event == self.EVENT:
            self.n += 1


def run_cli(argv: list[str], counter: CompileCounter) -> dict:
    """hammlet_tpu.cli.main in-process; returns the engine (the first one
    built), its setup seconds and the number of compiles the run took."""
    from hammlet_tpu import cli

    built: dict = {}
    make_engine = cli.make_engine

    def timed_make_engine(*args, **kwargs):
        t0 = time.perf_counter()
        eng = make_engine(*args, **kwargs)
        built.setdefault("setup_s", time.perf_counter() - t0)
        built.setdefault("engine", eng)
        return eng

    n0 = counter.n
    cli.make_engine = timed_make_engine
    try:
        rc = cli.main(argv)
    finally:
        cli.make_engine = make_engine
    if rc != 0:
        raise RuntimeError(f"hammlet {' '.join(argv)} exited {rc}")
    built["compiles"] = counter.n - n0
    return built


def cli_args(files: list[Path], prefix: Path, seed: int, extra=()) -> list[str]:
    return [
        "-f", *map(str, files), "-s", "3", "-a", "-R", str(seed),
        "-i", *CLI_SCHEME, "-O", *STREAMS, "-w", "-o", str(prefix), ".csv",
        *extra,
    ]


def peak_bytes(device) -> int:
    return int((device.memory_stats() or {}).get("peak_bytes_in_use", -1))


# ---- phases ----------------------------------------------------------------


def phase_a(ctx: Context) -> str:
    import jax

    from hammlet_tpu import native

    make = subprocess.run(
        ["make", "-C", str(REPO / "native")], capture_output=True, text=True
    )
    if make.returncode != 0:
        raise RuntimeError(f"make -C native failed:\n{make.stdout}{make.stderr}")
    if not native.available():
        raise RuntimeError("native library built but does not load")
    dev = jax.devices()[0]
    return (
        f"platform {dev.platform}, device_kind {dev.device_kind}, "
        f"{len(jax.devices())} device(s); native library built"
    )


def _timed(fn, *args, **kwargs):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args, **kwargs))
    return out, time.perf_counter() - t0


def ingest_timings(data: np.ndarray) -> str:
    """Cold and warm ingest_device wall, and the warm maxlet alone."""
    import jax.numpy as jnp

    from hammlet_tpu.ops.wavelet import maxlet_transform
    from hammlet_tpu.runner import ingest_device

    _, cold = _timed(lambda: ingest_device(data).weights)
    _, warm = _timed(lambda: ingest_device(data).weights)
    data_dev = jnp.asarray(data[:, None])
    _timed(maxlet_transform, data_dev)
    _, t_maxlet = _timed(maxlet_transform, data_dev)
    del data_dev
    return (
        f"ingest_device cold {cold:.3f} s, warm {warm:.3f} s; "
        f"maxlet alone warm {t_maxlet * 1e3:.2f} ms "
        f"({100 * t_maxlet / warm:.1f}% of warm ingest)"
    )


def phase_b(ctx: Context) -> str:
    import jax.numpy as jnp

    from hammlet_tpu.ops.blocks import build_prefix_stats
    from hammlet_tpu.ops.wavelet import maxlet_transform
    from hammlet_tpu.runner import ingest, ingest_device

    data, _, _ = ctx.wgs_main
    timings = ingest_timings(data)
    dev = ingest_device(data)
    host = ingest(data)
    np.testing.assert_array_equal(
        np.asarray(maxlet_transform(jnp.asarray(data[:, None]))), host.coeffs_host
    )
    np.testing.assert_array_equal(np.asarray(dev.weights), host.weights_host)
    np.testing.assert_array_equal(
        np.asarray(dev.ranked.pos_by_rank), np.asarray(host.ranked.pos_by_rank)
    )
    np.testing.assert_allclose(dev.noise_std, host.noise_std, rtol=1e-6)

    # prefix stats: the host's float64 build at the device's cell size; the
    # device's float32 in-cell cumsums may differ by summation order, so
    # the bound is rtol 1e-5 of the sum of magnitudes each entry covers
    ref = build_prefix_stats(data, cell_bits=dev.cell_bits)
    cell = 1 << dev.cell_bits
    T = len(data)
    n_cells = -(-T // cell)
    mag = np.zeros((n_cells * cell, 2))
    mag[:T, 0] = np.abs(data)
    mag[:T, 1] = data.astype(np.float64) ** 2
    mag = np.flip(np.cumsum(np.flip(mag.reshape(n_cells, cell, 2), 1), 1), 1)
    r_dev = np.asarray(dev.prefix.r_t)[0, :, :T].astype(np.float64)
    r_ref = np.asarray(ref.r_t)[0, :, :T].astype(np.float64)
    r_mag = mag.reshape(-1, 2)[:T].T
    r_err = np.max(np.abs(r_dev - r_ref) / (r_mag + 1e-30))
    q_dev = np.asarray(dev.prefix.q2_hi, np.float64) + np.asarray(dev.prefix.q2_lo)
    q_ref = np.asarray(ref.q2_hi, np.float64) + np.asarray(ref.q2_lo)
    q_mag = np.cumsum(mag[:, 0], axis=0)  # (n_cells, 2) cell totals
    q_mag = np.concatenate([q_mag, q_mag[-1:]])[:, None, :]
    q_err = np.max(np.abs(q_dev - q_ref) / (q_mag + 1e-30))
    if max(r_err, q_err) > 1e-5:
        raise AssertionError(f"prefix stats differ: in-cell {r_err:.2e}, cross-cell {q_err:.2e}")
    return (
        f"T={T}: maxlet, weights, ranking bit-identical to the native host "
        f"transform; noise {dev.noise_std:.7f} vs {host.noise_std:.7f}; prefix "
        f"rel. error in-cell {r_err:.2e}, cross-cell {q_err:.2e} (<= 1e-5); {timings}"
    )


def _sweep_pieces_fn():
    """One settled sweep's pieces, compiled for the card: the blocks at the
    model's threshold, their statistics, an FB state draw, and the sweep
    statistics and emission log-weights the products compute."""
    import jax

    from hammlet_tpu.models.distributions import emission_log_weights_t
    from hammlet_tpu.ops.blocks import block_sufficient_stats_t, make_blocks_bucketed
    from hammlet_tpu.samplers.forward_backward import fb_sample_states
    from hammlet_tpu.samplers.sweep import accumulate_sweep_stats

    @functools.partial(jax.jit, static_argnames=("cell_bits", "nr_params"))
    def pieces(key, model, ranked, cand_pos, cand_rank, prefix, mapping, *,
               cell_bits, nr_params):
        thr = model.threshold(ranked.pos_by_rank.shape[0])
        blocks = make_blocks_bucketed(cand_pos, cand_rank, ranked, thr)
        bstats = block_sufficient_stats_t(prefix, blocks, cell_bits)
        states = fb_sample_states(
            key, bstats, blocks.sizes, blocks.n_blocks, model.theta_mean,
            model.theta_var, model.A, model.pi, mapping, True,
        )
        stats = accumulate_sweep_stats(
            states, blocks.sizes, blocks.n_blocks, bstats, mapping, nr_params
        )
        log_e = emission_log_weights_t(
            bstats, blocks.sizes, model.theta_mean, model.theta_var, mapping
        )
        return blocks.sizes, blocks.n_blocks, states, bstats, stats, log_e

    return pieces


def phase_c(ctx: Context) -> str:
    import jax
    import jax.numpy as jnp

    eng = ctx.results["engine_d"]
    mapping = np.asarray(eng.spec.mapping(), np.int64)
    P = eng.spec.nr_params
    cand_pos, cand_rank = eng._candidates()
    sizes, nb, states, bstats, stats, log_e = jax.device_get(
        _sweep_pieces_fn()(
            jax.random.PRNGKey(ctx.seed), eng.model, eng.ing.ranked, cand_pos,
            cand_rank, eng.ing.prefix, jnp.asarray(mapping, jnp.int32),
            cell_bits=eng.ing.cell_bits, nr_params=P,
        )
    )
    nb = int(nb)
    if nb > eng.capacity:
        raise AssertionError(f"sweep has {nb} blocks > capacity {eng.capacity}")
    v = slice(0, nb)
    z, n = states[v].astype(np.int64), sizes[v].astype(np.int64)
    S = bstats[:, :, v].astype(np.float64)  # (dim, 2, nb)
    K = mapping.shape[0]

    state_counts = np.bincount(z, weights=n, minlength=K)
    prev = np.concatenate([[0], z[:-1]])
    trans = np.zeros((K, K))
    np.add.at(trans, (prev, z), 1.0)
    trans += np.diag(np.bincount(z, weights=n - 1, minlength=K))
    theta = np.zeros((3, P))
    theta_mag = np.zeros(P)
    for d in range(mapping.shape[1]):
        p = mapping[z, d]
        theta[0] += np.bincount(p, weights=S[d, 0], minlength=P)
        theta[1] += np.bincount(p, weights=S[d, 1], minlength=P)
        theta[2] += np.bincount(p, weights=n, minlength=P)
        theta_mag += np.bincount(p, weights=np.abs(S[d, 0]), minlength=P)

    for name, got, want in [
        ("state counts", stats.state_counts, state_counts),
        ("transition counts", stats.trans_counts, trans),
        ("theta counts", stats.theta_counts, theta[2]),
    ]:
        if not np.array_equal(np.asarray(got, np.float64), want):
            raise AssertionError(f"{name} differ: {got} vs {want}")
    sum_err = np.max(np.abs(stats.theta_sums - theta[0]) / (theta_mag + 1e-30))
    sq_err = np.max(np.abs(stats.theta_sumsqs - theta[1]) / (theta[1] + 1e-30))
    if max(sum_err, sq_err) > 1e-5:
        raise AssertionError(f"theta sums rel. error {sum_err:.2e}, sums of squares {sq_err:.2e}")

    tm = np.asarray(eng.model.theta_mean, np.float64)
    tv = np.asarray(eng.model.theta_var, np.float64)
    a, b = tm / tv, 0.5 / tv
    c = 0.5 * np.log(tv) + tm * tm * b
    want_e = (
        np.einsum("kd,db->kb", a[mapping], S[:, 0])
        - np.einsum("kd,db->kb", b[mapping], S[:, 1])
        - c[mapping].sum(axis=1)[:, None] * n[None, :]
    )
    # float32 rounding of a*Sx - b*Sx2 is ~1e-7 of |Sx2|/(2 var); TF32
    # operands (~5e-4) would be 1000x that
    scale = np.abs(S[:, 1]).sum(axis=0) / (2 * tv.min()) + np.abs(want_e)
    e_err = float(np.max(np.abs(log_e[:, v] - want_e) / scale))
    if e_err > 1e-5:
        raise AssertionError(f"emission log-weights rel. error {e_err:.2e} > 1e-5")
    return (
        f"capacity {eng.capacity}, {nb} blocks: counts exact; theta sums "
        f"rel. error {sum_err:.2e}, sums of squares {sq_err:.2e} (<= 1e-5); "
        f"log-weights error {e_err:.2e} of |Sx2|/(2 var) (<= 1e-5)"
    )


def phase_d(ctx: Context) -> str:
    import jax

    data, truth, path = ctx.wgs_main
    prefix = ctx.out / "d-"
    t0 = time.perf_counter()
    run = run_cli(cli_args([path], prefix, ctx.seed), ctx.counter)
    wall = time.perf_counter() - t0
    summary, freq = check_marginals(
        Path(f"{prefix}marginals.csv"), truth, recorded(CLI_SCHEME)
    )
    eng = run["engine"]
    ctx.results.update(engine_d=eng, freq_d=freq)
    return (
        f"hammlet -f <{len(data)} positions> -i {' '.join(CLI_SCHEME)}: "
        f"{summary}; {eng.sweeps_per_second:.2f} sweeps/s sampled "
        f"(capacity {eng.capacity}), setup {run['setup_s']:.2f} s, wall "
        f"{wall:.2f} s, peak device memory {peak_bytes(jax.devices()[0])} B, "
        f"{run['compiles']} compiles"
    )


def phase_e(ctx: Context) -> str:
    _, _, path = ctx.wgs_main
    prefix = ctx.out / "e-"
    run = run_cli(cli_args([path], prefix, ctx.seed), ctx.counter)
    differ = [
        s for s in STREAMS
        if Path(f"{ctx.out / 'd-'}{s}.csv").read_bytes()
        != Path(f"{prefix}{s}.csv").read_bytes()
    ]
    if differ:
        raise AssertionError(f"same seed, different bytes in: {', '.join(differ)}")
    eng = run["engine"]
    return (
        f"repeat run byte-identical in {', '.join(STREAMS)}; warm repeat: "
        f"{eng.sweeps_per_second:.2f} sweeps/s sampled, setup "
        f"{run['setup_s']:.2f} s, {run['compiles']} compiles"
    )


def phase_f(ctx: Context) -> str:
    import jax

    from hammlet_tpu.runner import make_engine

    data, _ = wgs_synthetic(T_CROSS, ctx.seed)
    freqs = {}
    for name, device in [("gpu", jax.devices()[0]), ("cpu", jax.devices("cpu")[0])]:
        with jax.default_device(device):
            eng = make_engine(data, nr_params=3, seed=ctx.seed)
            eng.run_scheme(CLI_SCHEME)
            counts = eng.marginal_counts  # (K, T)
        n_rec = recorded(CLI_SCHEME)
        if not np.all(counts.sum(axis=0) == n_rec):
            raise AssertionError(f"{name}: marginal counts do not sum to {n_rec}")
        freqs[name] = counts.T / n_rec
    dist = marginal_distance(freqs["gpu"], freqs["cpu"])
    if dist > MARGINAL_MAX_DIFF:
        raise AssertionError(f"GPU vs CPU marginals differ by {dist:.4f} > {MARGINAL_MAX_DIFF}")
    return f"T={T_CROSS}: GPU vs CPU marginals mean |diff| {dist:.4f} (<= {MARGINAL_MAX_DIFF})"


def phase_g(ctx: Context) -> str:
    import gc

    import jax

    from hammlet_tpu.runner import make_engine

    t0 = time.perf_counter()
    data, _ = wgs_synthetic(T_CHROM, ctx.seed)
    t_data = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = make_engine(data, nr_params=3, seed=ctx.seed)
    setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng.run_scheme(CHROM_SCHEME)
    jax.block_until_ready(eng.buffers.counts)
    run_wall = time.perf_counter() - t0
    peak = peak_bytes(jax.devices()[0])
    n_rec = int(np.asarray(eng.buffers.n_records))
    if n_rec != recorded(CHROM_SCHEME):
        raise AssertionError(f"{n_rec} recorded sweeps, expected {recorded(CHROM_SCHEME)}")
    bad = int(np.count_nonzero(eng.marginal_counts.sum(axis=0) != n_rec))
    if bad:
        raise AssertionError(f"{bad} positions' counts do not sum to {n_rec}")
    sps, cap = eng.sweeps_per_second, eng.capacity
    del eng
    gc.collect()
    timings = ingest_timings(data)
    return (
        f"T={T_CHROM}, -i {' '.join(CHROM_SCHEME)}: counts sum to {n_rec} at "
        f"every position; data {t_data:.1f} s, setup {setup:.2f} s, scheme "
        f"{run_wall:.2f} s at {sps:.3f} sweeps/s (final capacity {cap}), peak "
        f"device memory {peak} B; {timings}"
    )


def phase_h(ctx: Context) -> str:
    import jax

    if len(jax.devices()) < 4:
        raise RuntimeError(f"needs 4 devices, JAX sees {len(jax.devices())}")
    data, truth, path = ctx.wgs_main
    n_rec = recorded(CLI_SCHEME)
    one = run_cli(cli_args([path], ctx.out / "h1-", ctx.seed), ctx.counter)
    _, f1 = check_marginals(Path(f"{ctx.out / 'h1-'}marginals.csv"), truth, n_rec)
    t0 = time.perf_counter()
    run_cli(cli_args([path], ctx.out / "h4-", ctx.seed, ("-D", "4")), ctx.counter)
    wall4 = time.perf_counter() - t0
    s4, f4 = check_marginals(Path(f"{ctx.out / 'h4-'}marginals.csv"), truth, n_rec)
    dist = marginal_distance(f1, f4)
    if dist > MARGINAL_MAX_DIFF:
        raise AssertionError(f"-D 4 vs one card: marginals differ by {dist:.4f}")

    files = [
        ctx.dataset(f"chr{i}_1M", T_MULTI, ctx.seed + i)[2] for i in range(1, 5)
    ]
    t0 = time.perf_counter()
    run_cli(cli_args(files, ctx.out / "mp-", ctx.seed, ("-M",)), ctx.counter)
    wall_par = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_cli(cli_args(files, ctx.out / "ms-", ctx.seed, ("-M", "-D", "1")), ctx.counter)
    wall_seq = time.perf_counter() - t0
    differ = [
        f"{f.stem}-{s}"
        for f in files for s in STREAMS
        if Path(f"{ctx.out / 'mp-'}{f.stem}-{s}.csv").read_bytes()
        != Path(f"{ctx.out / 'ms-'}{f.stem}-{s}.csv").read_bytes()
    ]
    if differ:
        raise AssertionError(f"-M on 4 cards differs from sequential in {differ}")
    return (
        f"-D 4 on T={len(data)}: {s4}, vs one card mean |diff| {dist:.4f} "
        f"(<= {MARGINAL_MAX_DIFF}), wall {wall4:.2f} s (one card: setup "
        f"{one['setup_s']:.2f} s, {one['engine'].sweeps_per_second:.2f} sweeps/s); "
        f"-M over 4 x {T_MULTI} positions byte-identical to sequential, wall "
        f"{wall_par:.2f} s on 4 cards vs {wall_seq:.2f} s sequential"
    )


# ---- driver ----------------------------------------------------------------


def card_lines() -> list[str]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    which = parser.add_mutually_exclusive_group()
    which.add_argument("--full-chromosome", action="store_true")
    which.add_argument("--four", action="store_true")
    args = parser.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print(
            f"chip_smoke: needs a GPU; JAX's default backend is "
            f"{jax.default_backend()!r}",
            file=sys.stderr,
        )
        return 1
    sys.path.insert(0, str(REPO))

    cards = card_lines()
    for line in cards:
        print(f"nvidia-smi: {line}", flush=True)
    ctx = Context(args.seed)
    if args.full_chromosome:
        phases = [("a", phase_a, ()), ("g", phase_g, ())]
    elif args.four:
        phases = [("a", phase_a, ()), ("h", phase_h, ())]
    else:
        phases = [
            ("a", phase_a, ()), ("b", phase_b, ()), ("d", phase_d, ()),
            ("c", phase_c, ("d",)), ("e", phase_e, ("d",)), ("f", phase_f, ()),
        ]
    failed: list[str] = []
    for name, fn, needs in phases:
        t0 = time.perf_counter()
        if any(n in failed for n in needs):
            result = f"NOT RUN (needs phase {', '.join(needs)})"
            failed.append(name)
        else:
            try:
                result = f"ok: {fn(ctx)}"
            except Exception as e:  # report every phase, then fail the run
                traceback.print_exc()
                result = f"FAILED: {type(e).__name__}: {e}"
                failed.append(name)
        print(
            f"[{cards[0]}] phase {name} ({time.perf_counter() - t0:.1f} s) {result}",
            flush=True,
        )
    if failed:
        print(f"chip_smoke: phases failed: {', '.join(failed)}", file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
