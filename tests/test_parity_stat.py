"""Statistical parity vs the compiled reference: per-position marginal TV
distance within the reference's own MC-error envelope (SURVEY.md §7).

Replaces a flat 0.08 threshold: the tolerance is measured, per config, from
reference-vs-reference seed pairs."""

import numpy as np
import pytest

from hammlet_tpu.cli import main as cli_main
from hammlet_tpu.golden.parity import (
    ensure_reference_binary,
    parity_bound,
    parity_report,
    read_marginals,
)


@pytest.fixture(scope="module")
def ref_bin():
    b = ensure_reference_binary()
    if b is None:
        pytest.skip("cannot compile reference binary")
    return b


def _ambiguous_univariate(T, seed):
    """3 states with overlapping emissions so posteriors are genuinely
    uncertain (a well-separated dataset makes every run trivially equal)."""
    rng = np.random.default_rng(seed)
    means = [0.0, 2.5, -2.5]
    segs = []
    t = 0
    while t < T:
        n = min(int(rng.integers(60, 300)), T - t)
        segs.append(rng.normal(means[rng.integers(0, 3)], 1.0, size=n))
        t += n
    return np.concatenate(segs).astype(np.float32)


def _run_ours(tmp_path, data_file, scheme, s_args, tag, n_devices=None):
    argv = ["-f", data_file, "-a", "-R", "7", "-s", *s_args,
            "-o", str(tmp_path / f"{tag}-"), ".csv",
            "-i", *scheme, "-O", "marginals", "-w"]
    if n_devices:
        argv += ["-D", str(n_devices)]
    assert cli_main(argv) == 0
    return read_marginals(tmp_path / f"{tag}-marginals.csv")


def _assert_within_envelope(rep):
    # within the measured MC envelope; see golden.parity.parity_bound for
    # the derivation (mean + max(4*sigma_pair, 0.15*mean) + 0.002)
    assert rep["ours_mean"] <= parity_bound(rep), rep


def test_parity_univariate_3state(tmp_path, ref_bin):
    """BASELINE config 1 (synthetic array-CGH), CI-scaled."""
    data = _ambiguous_univariate(20_000, seed=12)
    f = tmp_path / "d.csv"
    np.savetxt(f, data)
    scheme = "M 100 0 F 100 0 F 200 2".split()
    ours = _run_ours(tmp_path, str(f), scheme, ["3"], "ours")
    rep = parity_report(ref_bin, str(f), str(tmp_path), scheme, ["3"], ours)
    _assert_within_envelope(rep)


def test_parity_univariate_sharded(tmp_path, ref_bin):
    """Same config through the position-sharded engine (8 devices)."""
    data = _ambiguous_univariate(20_000, seed=12)
    f = tmp_path / "d.csv"
    np.savetxt(f, data)
    scheme = "M 100 0 F 100 0 F 200 2".split()
    ours = _run_ours(tmp_path, str(f), scheme, ["3"], "ours8", n_devices=8)
    rep = parity_report(ref_bin, str(f), str(tmp_path), scheme, ["3"], ours)
    _assert_within_envelope(rep)


def test_parity_coriell_5state(tmp_path, ref_bin):
    """BASELINE config 2 (Coriell-like array-CGH): ~2.3k probes, 5 states
    under auto-priors — long copy-neutral stretches with short aberrant
    segments at overlapping log-ratio levels. This is the config that
    stresses the 5-state auto-prior closed form (AutoPriors.hpp:86-107)
    and the label-permutation alignment hardest."""
    rng = np.random.default_rng(21)
    T = 2300
    levels = [-1.0, -0.45, 0.0, 0.45, 1.0]  # del/loss/neutral/gain/amp
    segs = []
    t = 0
    while t < T:
        if rng.random() < 0.65:  # copy-neutral stretch
            n, lvl = int(rng.integers(150, 400)), 2
        else:  # short aberration
            n, lvl = int(rng.integers(30, 120)), int(rng.integers(0, 5))
        n = min(n, T - t)
        segs.append(rng.normal(levels[lvl], 0.35, size=n))
        t += n
    data = np.concatenate(segs).astype(np.float32)
    f = tmp_path / "coriell.csv"
    np.savetxt(f, data)
    scheme = "M 100 0 F 100 0 F 200 2".split()
    ours = _run_ours(tmp_path, str(f), scheme, ["5"], "ours5")
    rep = parity_report(ref_bin, str(f), str(tmp_path), scheme, ["5"], ours)
    _assert_within_envelope(rep)


def test_parity_wgs_chain(tmp_path, ref_bin):
    """BASELINE config 3 (single-chromosome WGS depth), CI-scaled to
    T=100k (set HAMMLET_PARITY_WGS_T=250000000 for the full-size chain):
    long read-depth-like segments, 3 states, genuinely long chain through
    the same envelope harness."""
    import os

    T = int(os.environ.get("HAMMLET_PARITY_WGS_T", 100_000))
    rng = np.random.default_rng(31)
    means = [0.0, 1.8, -1.8]  # depth log-ratios at moderate SNR
    segs = []
    t = 0
    while t < T:
        n = min(int(rng.integers(400, 3000)), T - t)
        segs.append(rng.normal(means[rng.integers(0, 3)], 1.0, size=n))
        t += n
    data = np.concatenate(segs).astype(np.float32)
    f = tmp_path / "wgs.csv"
    np.savetxt(f, data)
    scheme = "M 60 0 F 60 0 F 120 2".split()
    ours = _run_ours(tmp_path, str(f), scheme, ["3"], "oursw")
    rep = parity_report(ref_bin, str(f), str(tmp_path), scheme, ["3"], ours)
    _assert_within_envelope(rep)


def test_parity_multivariate(tmp_path, ref_bin):
    """BASELINE config 4 (multivariate mapping), CI-scaled: C 2 2 -> 4
    states over 2 data dims."""
    rng = np.random.default_rng(3)
    T = 6000
    means = [0.0, 2.2]
    segs = []
    t = 0
    while t < T:
        n = min(int(rng.integers(50, 250)), T - t)
        m = [means[rng.integers(0, 2)], means[rng.integers(0, 2)]]
        segs.append(rng.normal(m, 1.0, size=(n, 2)))
        t += n
    data = np.concatenate(segs).astype(np.float32)
    f = tmp_path / "d2.csv"
    np.savetxt(f, data.reshape(-1))  # row-major stream, dim values per pos
    scheme = "M 80 0 F 80 0 F 160 2".split()
    s_args = ["C", "2", "2"]
    ours = _run_ours(tmp_path, str(f), scheme, s_args, "ours2")
    rep = parity_report(ref_bin, str(f), str(tmp_path), scheme, s_args, ours)
    _assert_within_envelope(rep)
