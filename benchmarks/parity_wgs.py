"""WGS-scale statistical-parity check against the reference binary.

The exact config of tests/test_parity_stat.py::test_parity_wgs_chain
(BASELINE config 3: single-chromosome WGS depth-of-coverage chain) at a
genuinely large T, judged by the same MC-envelope harness
(hammlet_tpu.golden.parity): our CLI run's marginals must sit within the
reference-vs-reference seed envelope. Writes chiprun_out/parity_wgs.json
with the full report dict + acceptance bound.

Ours runs on whatever backend is active; the five reference runs are the
compiled C++ binary on the host CPU and execute AFTER ours, so the two
never compete for host cores.

Usage:  timeout 7200 python benchmarks/parity_wgs.py
Env:    HAMMLET_PARITY_WGS_T (default 2_000_000)
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def wgs_data(T: int) -> np.ndarray:
    """Identical generator to test_parity_stat.test_parity_wgs_chain."""
    rng = np.random.default_rng(31)
    means = [0.0, 1.8, -1.8]
    segs = []
    t = 0
    while t < T:
        n = min(int(rng.integers(400, 3000)), T - t)
        segs.append(rng.normal(means[rng.integers(0, 3)], 1.0, size=n))
        t += n
    return np.concatenate(segs).astype(np.float32)


def main() -> int:
    from hammlet_tpu.cli import main as cli_main
    from hammlet_tpu.golden.parity import (
        ensure_reference_binary,
        parity_bound,
        parity_report,
        read_marginals,
    )
    from hammlet_tpu.runner import enable_compilation_cache

    enable_compilation_cache()
    T = int(os.environ.get("HAMMLET_PARITY_WGS_T", 2_000_000))
    scheme = "M 60 0 F 60 0 F 120 2".split()
    ref_bin = ensure_reference_binary()
    assert ref_bin, "reference binary failed to compile"

    outdir = tempfile.mkdtemp(prefix="parity_wgs_")
    data = wgs_data(T)
    f = os.path.join(outdir, "wgs.csv")
    print(f"[parity_wgs] T={T}: writing data", file=sys.stderr, flush=True)
    with open(f, "w") as fh:
        for i in range(0, T, 1_000_000):
            fh.write("\n".join(f"{v:.5f}" for v in data[i : i + 1_000_000]))
            fh.write("\n")

    print("[parity_wgs] running ours (CLI)", file=sys.stderr, flush=True)
    t0 = time.time()
    rc = cli_main(
        ["-f", f, "-a", "-R", "7", "-s", "3",
         "-o", os.path.join(outdir, "ours-"), ".csv",
         "-i", *scheme, "-O", "marginals", "-w"]
    )
    assert rc == 0
    ours_s = time.time() - t0
    ours = read_marginals(os.path.join(outdir, "ours-marginals.csv"))
    print(f"[parity_wgs] ours done in {ours_s:.0f}s; running 5 reference "
          "seeds", file=sys.stderr, flush=True)

    t0 = time.time()
    rep = parity_report(ref_bin, f, outdir, scheme, ["3"], ours)
    ref_s = time.time() - t0
    rep_out = {
        "config": "BASELINE config 3 (WGS chain), "
        "tests/test_parity_stat.py::test_parity_wgs_chain at scale",
        "T": T,
        "scheme": " ".join(scheme),
        "ours_seed": 7,
        "ref_seeds": [1, 2, 3, 4, 5],
        "bound": parity_bound(rep),
        "pass": bool(rep["ours_mean"] <= parity_bound(rep)),
        "ours_wall_s": round(ours_s, 1),
        "reference_runs_wall_s": round(ref_s, 1),
        **{k: rep[k] for k in ("envelope_mean", "envelope_std",
                               "envelope_max", "ours_mean", "ours_max",
                               "pairs", "ours")},
    }
    print(json.dumps(rep_out), flush=True)
    out = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "chiprun_out", "parity_wgs.json",
    )
    os.makedirs(os.path.dirname(out), exist_ok=True)
    json.dump(rep_out, open(out, "w"), indent=1)
    assert rep_out["pass"], rep_out
    return 0


if __name__ == "__main__":
    sys.exit(main())
