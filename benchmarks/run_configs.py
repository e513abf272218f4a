"""Benchmark harness for the five BASELINE.json configs, ours VS the
compiled reference binary per config.

Phase 1 measures our engine on every requested config (on whatever backend
JAX runs); phase 2 replays the SAME data files and scheme through the compiled
reference binary on the host CPU (its native habitat — the reference is
single-threaded C++), isolating sampling time exactly the way bench.py
does (two runs differing only in the measured F sweeps). Phases are
sequential on purpose: overlapping the device run with a host run
starves the device run's host thread and corrupts both.

Writes chiprun_out/configs.json (one entry per config with ours +
reference sweeps/s and the honest ratio, losing configs included).

Sizes scale via HAMMLET_BENCH_SCALE (default 1.0 runs config 3 at 8M of
its ~250M positions and config 5 at 2M per device). Config 5 (the
position-sharded engine) runs on whatever devices exist.

Usage: timeout 5400 python -u benchmarks/run_configs.py [config-numbers...]
Env:   HAMMLET_CONFIGS_REF=0 to skip the reference phase.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SCALE = float(os.environ.get("HAMMLET_BENCH_SCALE", "1.0"))
WORKDIR = os.path.join(REPO, ".bench", "configs")
REF_BIN = os.path.join(REPO, ".bench", "hammlet_ref")
BURNIN, WARM, SWEEPS, THIN = 64, 64, 128, 4
#: measured F-phase length per config: long enough that the compiled chunk
#: length reaches the capacity-scaled target (runner._chunk_for_capacity) —
#: a 128-sweep phase compiles as ONE 128-sweep chunk and pays the per-chunk
#: launch and sync per 128 sweeps (and real users run hundreds of sweeps
#: per phase)
SWEEPS_FOR = {1: 1024, 2: 1024, 3: 512, 4: 1024, 5: 512}

RESULTS: dict[int, dict] = {}


def log(msg):
    print(f"[configs +{time.time() - _T0:.1f}s] {msg}", file=sys.stderr,
          flush=True)


_T0 = time.time()


def _engine_metrics(eng, desc, cfg, burnin=BURNIN, sweeps=SWEEPS, thin=THIN):
    eng.run("M", burnin, 0)
    # warm TWO rounds of the measured length: the first may shrink the
    # block capacity, the second compiles the measured program at the
    # settled capacity — compiled chunk lengths depend on the phase length
    # (runner._chunk_for_capacity + tail chunks), so warming with any
    # OTHER length leaves a cold compile inside the measured window
    eng.run("F", sweeps, thin)
    eng.run("F", sweeps, thin)
    eng.total_sweeps = 0.0
    eng.sample_time = 0.0
    eng.run("F", sweeps, thin)
    m = eng.metrics()
    out = {
        "config": cfg,
        "desc": desc,
        "T": int(getattr(eng, "T", getattr(getattr(eng, "ing", None), "T", 0))),
        "states": int(eng.spec.nr_states),
        "sweeps_per_second": round(m["sweeps_per_second"], 3),
        "positions_per_second": round(m["positions_per_second"], 1),
    }
    if m.get("compression_ratio"):
        out["compression_ratio"] = round(m["compression_ratio"], 1)
    if "n_devices" in m:
        out["n_devices"] = m["n_devices"]
    print(json.dumps(out), flush=True)
    RESULTS[cfg] = out


def _steps(means, seglen, T, noise, seed, dim=1):
    rng = np.random.default_rng(seed)
    n_seg = max(1, T // seglen)
    state = rng.integers(0, len(means), size=n_seg)
    reps = np.full(n_seg, seglen)
    reps[-1] = T - seglen * (n_seg - 1)
    mu = np.repeat(np.asarray(means)[state], reps, axis=0)
    return (mu + rng.normal(0, noise, size=mu.shape)).astype(np.float32)


def _data_file(cfg: int, data: np.ndarray) -> str:
    os.makedirs(WORKDIR, exist_ok=True)
    path = os.path.join(WORKDIR, f"cfg{cfg}_{data.shape[0]}.csv")
    if not os.path.exists(path):
        arr = data if data.ndim == 2 else data[:, None]
        with open(path, "w") as fh:
            for i in range(0, len(arr), 1_000_000):
                chunk = arr[i: i + 1_000_000]
                fh.write(
                    "\n".join(" ".join(f"{v:.5f}" for v in row)
                              for row in chunk)
                )
                fh.write("\n")
    return path


def config1():
    """Synthetic array-CGH, ~100k points, 3 states, auto priors."""
    from hammlet_tpu.runner import make_engine

    T = int(100_000 * max(SCALE, 0.01))
    data = _steps([0.0, 1.0, -1.0], 2000, T, 0.35, seed=1)
    _data_file(1, data)
    eng = make_engine(data, nr_params=3, seed=0)
    _engine_metrics(eng, "synthetic array-CGH ~100k, 3 states", 1,
                    sweeps=SWEEPS_FOR[1])
    RESULTS[1]["nr_params"] = 3


def config2():
    """Coriell-like array-CGH: sparse CNVs on a diploid baseline, 5 states.

    (The Coriell GM05296/GM13330 arrays are ~2k-probe log2-ratio tracks; the
    synthetic stand-in reproduces their structure: long 0-baseline, short
    +-gain/loss segments, probe noise ~0.15.)"""
    from hammlet_tpu.runner import make_engine

    T = int(2_300 * max(SCALE, 0.5))
    rng = np.random.default_rng(7)
    data = np.zeros(T, np.float32)
    for lo, hi, lvl in [(300, 380, 0.58), (1100, 1240, -0.7), (1900, 1960, 1.0)]:
        lo = min(lo, T - 2); hi = min(hi, T - 1)
        data[lo:hi] = lvl
    data += rng.normal(0, 0.15, T).astype(np.float32)
    _data_file(2, data)
    eng = make_engine(data, nr_params=5, seed=0)
    _engine_metrics(eng, "Coriell-like array-CGH, 5 states, auto priors", 2,
                    sweeps=SWEEPS_FOR[2])
    RESULTS[2]["nr_params"] = 5


def config3():
    """WGS depth-of-coverage, single chromosome. Full size is ~250M
    positions; default scale runs 8M of them."""
    from hammlet_tpu.runner import make_engine

    T = int(8_000_000 * SCALE)
    data = _steps([0.0, 2.0, -2.0], 500, T, 1.0, seed=3)
    _data_file(3, data)
    eng = make_engine(data, nr_params=3, seed=0)
    _engine_metrics(eng, f"WGS depth-of-coverage chromosome ({T/1e6:.0f}M)",
                    3, sweeps=SWEEPS_FOR[3])
    RESULTS[3]["nr_params"] = 3


def config4():
    """Multi-track multivariate emissions: 2 tracks x 3 params = 9 states."""
    from hammlet_tpu.runner import make_engine

    T = int(400_000 * max(SCALE, 0.01))
    means = [[0.0, 0.0], [0.0, 3.0], [3.0, 0.0], [3.0, 3.0], [-3.0, 0.0],
             [0.0, -3.0], [-3.0, -3.0], [3.0, -3.0], [-3.0, 3.0]]
    data = _steps(means, 800, T, 1.0, seed=4, dim=2)
    _data_file(4, data)
    eng = make_engine(data, nr_params=3, nr_data_dim=2, seed=0)
    _engine_metrics(eng, "multivariate 2-track, 9 states", 4,
                    sweeps=SWEEPS_FOR[4])
    RESULTS[4]["nr_params"] = 3


def config5():
    """Position-sharded multi-device run (the 3 Gbp/multi-host config,
    scaled to the devices present)."""
    import jax

    from hammlet_tpu.parallel import make_sharded_engine, position_mesh

    n_dev = len(jax.devices())
    T = int(2_000_000 * SCALE) * max(n_dev, 1)
    data = _steps([0.0, 2.0, -2.0], 500, T, 1.0, seed=5)
    _data_file(5, data)
    eng = make_sharded_engine(
        data, mesh=position_mesh(n_dev), nr_params=3, seed=0
    )
    _engine_metrics(
        eng, f"position-sharded over {n_dev} device(s) ({T/1e6:.0f}M)", 5,
        burnin=32, sweeps=SWEEPS_FOR[5],
    )
    RESULTS[5]["nr_params"] = 3
    RESULTS[5]["ref_note"] = (
        "reference is single-process C++; its number is the same data on "
        "one host core (the only way a reference user can run it)"
    )


def _ensure_ref() -> bool:
    if os.path.exists(REF_BIN):
        return True
    os.makedirs(os.path.dirname(REF_BIN), exist_ok=True)
    r = subprocess.run(
        ["g++", "-O3", "--std=c++11", "-include", "limits", "-o", REF_BIN,
         "/root/reference/src/main.cpp"],
        capture_output=True, text=True,
    )
    return r.returncode == 0


def _reference_sps(cfg: int) -> float | None:
    """Reference sweeps/s on this config's data file, sampling time
    isolated by differencing two runs that differ only in the measured
    F sweeps (bench.py protocol). Cached per (config, sizes)."""
    e = RESULTS[cfg]
    burnin = 32 if cfg == 5 else BURNIN
    sweeps = SWEEPS_FOR.get(cfg, SWEEPS)
    path = os.path.join(WORKDIR, f"cfg{cfg}_{e['T']}.csv")
    cache = path + f".ref_{burnin}_{sweeps}.json"
    if os.path.exists(cache):
        return json.load(open(cache))["sweeps_per_second"]
    if not (_ensure_ref() and os.path.exists(path)):
        return None
    out = os.path.join(WORKDIR, f"ref{cfg}-")

    def run(n_sweeps):
        t0 = time.time()
        subprocess.run(
            [REF_BIN, "-f", path, "-s", str(e["nr_params"]), "-a", "-R", "0",
             "-o", out, ".csv", "-O", "marginals",
             "-i", "M", str(burnin), "0", "F", str(WARM + n_sweeps),
             str(THIN), "-w"],
            check=True, capture_output=True, timeout=3600,
        )
        return time.time() - t0

    log(f"reference config {cfg}: base run")
    t_base = run(0)
    log(f"reference config {cfg}: base {t_base:.1f}s; full run")
    t_full = run(sweeps)
    sps = sweeps / max(t_full - t_base, 1e-6)
    log(f"reference config {cfg}: {sps:.1f} sweeps/s")
    json.dump({"sweeps_per_second": sps}, open(cache, "w"))
    return sps


def main(argv):
    from hammlet_tpu.runner import enable_compilation_cache

    enable_compilation_cache()
    with_ref = os.environ.get("HAMMLET_CONFIGS_REF", "1") == "1"
    wanted = [int(a) for a in argv if a.isdigit()] or [1, 2, 3, 4, 5]
    fns = {1: config1, 2: config2, 3: config3, 4: config4, 5: config5}
    for c in wanted:
        t0 = time.time()
        fns[c]()
        log(f"config {c} (ours) wall {time.time()-t0:.1f}s")
    if with_ref:
        for c in wanted:
            try:
                ref = _reference_sps(c)
            except subprocess.SubprocessError as err:
                log(f"reference config {c} failed: {err}")
                ref = None
            if ref:
                RESULTS[c]["reference_sweeps_per_second"] = round(ref, 3)
                RESULTS[c]["vs_reference"] = round(
                    RESULTS[c]["sweeps_per_second"] / ref, 3
                )
    report = {
        "metric": "BASELINE.json five-config sweep throughput, ours vs the "
        "compiled reference binary (same data file, same -i scheme; "
        "sampling time isolated by run differencing)",
        "scale": SCALE,
        "scheme": f"M {BURNIN} 0 (config 5: M 32 0), warm 2x + measure "
        f"F {SWEEPS_FOR} {THIN}; reference runs F {WARM}+measured with "
        "run differencing",
        "reference_host": "this machine's host CPU (single-threaded C++)",
        "configs": [RESULTS[c] for c in sorted(RESULTS)],
    }
    print(json.dumps(report), flush=True)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    json.dump(report, open(os.path.join(REPO, "chiprun_out", "configs.json"), "w"),
              indent=1)


if __name__ == "__main__":
    main(sys.argv[1:])
