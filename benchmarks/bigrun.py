"""Single-chip end-to-end run at the reference's own advertised scale.

The reference claims ~100,000,000 points feasible on a laptop
(/root/reference/doc/hammlet-manpage.md:178); BASELINE config 3 is a
~250M-position WGS chromosome. This harness drives the REAL CLI front door
(bin/hammlet) on a T-position synthetic WGS file with marginals output,
records wall times per stage plus the CLI-reported sweep throughput, and
writes chiprun_out/bigrun<T/1M>.json (data in .bench/, both gitignored).

Usage:  timeout 7200 python -u benchmarks/bigrun.py
Env:    HAMMLET_BIGRUN_T       (default 100_000_000)
        HAMMLET_BIGRUN_SCHEME  (default "M 64 0 F 100 4")
        HAMMLET_BIGRUN_OUT     (default chiprun_out/bigrun<T/1M>.json)
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def log(msg):
    print(f"[bigrun +{time.time() - _T0:.1f}s] {msg}", file=sys.stderr,
          flush=True)


_T0 = time.time()


def write_data(path: str, T: int, seglen: int = 500) -> None:
    """WGS-depth-like synthetic written in bounded-memory chunks (same
    model as bench.synth: 3 means at +-2 sigma, ~seglen segments)."""
    rng = np.random.default_rng(0)
    means = np.array([0.0, 2.0, -2.0])
    with open(path, "w") as fh:
        done = 0
        while done < T:
            n = min(4_000_000, T - done)
            n_seg = -(-n // seglen)
            state = rng.integers(0, 3, size=n_seg)
            mu = np.repeat(means[state], seglen)[:n]
            vals = (mu + rng.normal(0, 1, size=n)).astype(np.float32)
            fh.write("\n".join(f"{v:.5f}" for v in vals))
            fh.write("\n")
            done += n
            if done % 20_000_000 < 4_000_000:
                log(f"data {done/1e6:.0f}M/{T/1e6:.0f}M")


def main() -> int:
    T = int(os.environ.get("HAMMLET_BIGRUN_T", 100_000_000))
    scheme = os.environ.get("HAMMLET_BIGRUN_SCHEME", "M 64 0 F 100 4").split()
    workdir = os.path.join(REPO, ".bench", "bigrun")
    os.makedirs(workdir, exist_ok=True)
    data_file = os.path.join(workdir, f"wgs_{T}.csv")
    if not os.path.exists(data_file):
        log(f"writing {T/1e6:.0f}M-position data file")
        write_data(data_file, T)
    log(f"data file ready ({os.path.getsize(data_file)/1e9:.2f} GB)")

    prefix = os.path.join(workdir, "big-")
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-u", os.path.join(REPO, "bin", "hammlet"),
         "-f", data_file, "-s", "3", "-a", "-R", "0",
         "-o", prefix, ".csv", "-O", "marginals", "compression",
         "-i", *scheme, "-v", "-w"],
        capture_output=True, text=True, timeout=6000,
    )
    wall = time.time() - t0
    sys.stderr.write(proc.stdout[-3000:] + proc.stderr[-2000:])
    assert proc.returncode == 0, proc.stderr[-2000:]
    m = re.search(r"Sampled (\d+) sweeps at ([\d.]+) sweeps/s", proc.stdout)
    sweeps, sps = (int(m.group(1)), float(m.group(2))) if m else (None, None)

    # validate the marginals artifact: rows sum to T positions and every
    # row's counts sum to the number of recorded sweeps
    n_rec = 0
    tot_pos = 0
    n_rows = 0
    with open(prefix + "marginals.csv") as fh:
        for line in fh:
            parts = line.split("\t")
            tot_pos += int(parts[0])
            c = sum(int(x) for x in parts[1:])
            if n_rows == 0:
                n_rec = c
            assert c == n_rec, (n_rows, c, n_rec)
            n_rows += 1
    assert tot_pos == T, (tot_pos, T)
    comp = [float(x) for x in open(prefix + "compression.csv").read().split()]

    out = {
        "metric": "end-to-end bin/hammlet single chip (BASELINE config 3 "
        "scale; reference claims ~100M feasible, "
        "doc/hammlet-manpage.md:178)",
        "T": T,
        "scheme": " ".join(scheme),
        "data_file_gb": round(os.path.getsize(data_file) / 1e9, 2),
        "wall_s_total": round(wall, 1),
        "sweeps": sweeps,
        "sampling_sweeps_per_second": sps,
        "marginals_rows": n_rows,
        "recorded_sweeps_per_row": n_rec,
        "final_compression_ratio": comp[-1] if comp else None,
        "positions_per_second": round(sps * T, 0) if sps else None,
        "capacity_ceiling": int(os.environ.get("HAMMLET_MAX_CAPACITY", 0))
        or (1 << 25),
        "burnin_note": "burn-in chunks above the capacity ceiling run "
        "TRUNCATED to the top-capacity ranked weights (runner._MAX_CAPACITY"
        "; recording sweeps are never truncated) — this bounds the "
        "transient device-memory working set of the ~T-block burn-in",
    }
    print(json.dumps(out), flush=True)
    name = os.environ.get(
        "HAMMLET_BIGRUN_OUT",
        os.path.join("chiprun_out", f"bigrun{T // 1_000_000}.json"),
    )
    path = os.path.join(REPO, name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    json.dump(out, open(path, "w"), indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
