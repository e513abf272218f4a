"""End-to-end: engine + CLI against synthetic 3-state data, plus format
parity with the compiled reference binary (used strictly as a test oracle)."""

import os
import subprocess

import numpy as np
import pytest

from hammlet_tpu.cli import main as cli_main
from hammlet_tpu.runner import make_engine, parse_scheme
from hammlet_tpu.io.records import Records

REF_BIN = "/tmp/hammlet_ref/hammlet"


def synth_data(T=2000, seed=0):
    """Piecewise-constant 3-state Gaussian data with well-separated means."""
    rng = np.random.default_rng(seed)
    means = [0.0, 5.0, -5.0]
    segs, states = [], []
    t = 0
    s = 0
    while t < T:
        n = min(int(rng.integers(100, 400)), T - t)
        s = int(rng.integers(0, 3))
        segs.append(rng.normal(means[s], 1.0, size=n))
        states.extend([s] * n)
        t += n
    return np.concatenate(segs).astype(np.float32), np.array(states), means


@pytest.fixture(scope="session")
def ref_binary():
    """Compile the reference binary once as an end-to-end oracle."""
    if not os.path.exists(REF_BIN):
        os.makedirs(os.path.dirname(REF_BIN), exist_ok=True)
        r = subprocess.run(
            [
                "g++", "-O2", "--std=c++11", "-include", "limits",
                "-o", REF_BIN, "/root/reference/src/main.cpp",
            ],
            capture_output=True,
            text=True,
        )
        if r.returncode != 0:
            pytest.skip(f"cannot compile reference binary: {r.stderr[-500:]}")
    return REF_BIN


def test_parse_scheme_default():
    ops = parse_scheme("M 500 0 S P F 200 0 F 300 3".split())
    assert ops == [
        ("prior",),
        ("run", "M", 500, 0),
        ("static",),
        ("prior",),
        ("run", "F", 200, 0),
        ("run", "F", 300, 3),
    ]
    with pytest.raises(ValueError):
        parse_scheme("F 10".split())


def test_engine_recovers_segmentation(tmp_path):
    data, true_states, means = synth_data(T=3000, seed=1)
    rec = Records(
        len(data), str(tmp_path / "out-"), ".csv", 3,
        outputs={"marginals", "sequences", "blocks", "compression",
                 "parameters", "segments"},
        overwrite=True,
    )
    eng = make_engine(data, nr_params=3, seed=7, records=rec)
    eng.run_scheme("M 50 0 F 50 0 F 60 3".split())
    eng.finalize()

    # marginal counts: every row sums to the number of recorded sweeps (20)
    rows = [
        list(map(int, line.split("\t")))
        for line in (tmp_path / "out-marginals.csv").read_text().splitlines()
    ]
    T = len(data)
    assert sum(r[0] for r in rows) == T
    for r in rows:
        assert sum(r[1:]) == 20
    # max-marginal segmentation should match the planted one nearly everywhere
    pos_state = np.zeros(T, dtype=int)
    t = 0
    for r in rows:
        pos_state[t : t + r[0]] = int(np.argmax(r[1:]))
        t += r[0]
    # map sampled labels to true labels by majority vote
    agree = 0
    for s in range(3):
        mask = pos_state == s
        if mask.sum():
            true_label = np.bincount(true_states[mask], minlength=3).argmax()
            agree += (true_states[mask] == true_label).sum()
    assert agree / T > 0.98

    # sequences file: 20 lines, each RLE summing to T
    seq_lines = (tmp_path / "out-sequences.csv").read_text().splitlines()
    assert len(seq_lines) == 20
    for line in seq_lines:
        toks = [tok.split(":") for tok in line.split("\t")]
        assert sum(int(n) for n, _ in toks) == T

    # blocks: sizes sum to T; compression: one float per recorded sweep
    blk_lines = (tmp_path / "out-blocks.csv").read_text().splitlines()
    assert len(blk_lines) == 20
    for line in blk_lines:
        assert sum(map(int, line.split("\t"))) == T
    comp = [float(x) for x in (tmp_path / "out-compression.csv").read_text().split()]
    assert len(comp) == 20 and all(c >= 1 for c in comp)

    # parameters: 20 lines x 3 params x (mean, var)
    par_lines = (tmp_path / "out-parameters.csv").read_text().splitlines()
    assert len(par_lines) == 20
    fitted = sorted(float(par_lines[-1].split("\t")[i]) for i in (0, 2, 4))
    assert np.allclose(fitted, sorted(means), atol=0.5)

    # segments: 20 lines of "nseg\tinternal"; the recorded segment count is
    # the cumulative boundary-union size + 1 and can only grow
    seg_lines = (tmp_path / "out-segments.csv").read_text().splitlines()
    assert len(seg_lines) == 20
    nsegs = [int(line.split("\t")[0]) for line in seg_lines]
    assert all(a <= b for a, b in zip(nsegs, nsegs[1:]))
    # the final count matches the marginals row count (same boundary union)
    assert nsegs[-1] == len(rows)


def test_cli_smoke(tmp_path):
    data, _, _ = synth_data(T=1200, seed=3)
    fn = tmp_path / "data.csv"
    np.savetxt(fn, data)
    rc = cli_main(
        ["-f", str(fn), "-s", "3", "-a", "-R", "0", "-i", "M", "20", "0",
         "F", "30", "3", "-O", "marginals", "parameters", "-w"]
    )
    assert rc == 0
    assert (tmp_path / "data-marginals.csv").exists()
    assert (tmp_path / "data-parameters.csv").exists()


def test_cli_sharded_with_checkpoint(tmp_path):
    """-D engages the position-sharded engine; -C checkpoints it; a rerun
    with the checkpoint present resumes (scheme complete -> no-op) and the
    marginals stay valid."""
    data, _, _ = synth_data(T=1500, seed=9)
    fn = tmp_path / "data.csv"
    np.savetxt(fn, data)
    ck = tmp_path / "run.ckpt"
    argv = [
        "-f", str(fn), "-s", "3", "-a", "-R", "4", "-D", "2",
        "-i", "M", "8", "0", "F", "12", "2", "-O", "marginals", "-w",
        "-C", str(ck), "4",
    ]
    assert cli_main(argv) == 0
    assert ck.exists()
    first = (tmp_path / "data-marginals.csv").read_text()
    rows = [list(map(int, l.split("\t"))) for l in first.splitlines()]
    assert all(sum(r[1:]) == 6 for r in rows)
    assert sum(r[0] for r in rows) == 1500

    # resume from the final checkpoint: nothing left to run, output intact
    assert cli_main(argv) == 0
    rows2 = [
        list(map(int, l.split("\t")))
        for l in (tmp_path / "data-marginals.csv").read_text().splitlines()
    ]
    assert all(sum(r[1:]) == 6 for r in rows2)


def test_format_parity_with_reference(tmp_path, ref_binary):
    """Run the compiled reference and our CLI on the same data with every
    stream enabled and check the full token grammar + structural
    invariants of each stream on BOTH outputs (Records.hpp:155-235,
    StateMarginals.hpp:268-310). Statistical content is test_parity_stat's
    job; this test must fail on any format change."""
    import re

    data, true_states, _ = synth_data(T=2500, seed=5)
    T = len(data)
    fn = tmp_path / "d.csv"
    np.savetxt(fn, data)
    streams = ["marginals", "sequences", "blocks", "compression",
               "parameters", "segments"]
    n_rec = 10  # F 30 thin 3

    subprocess.run(
        [ref_binary, "-f", str(fn), "-s", "3", "-a", "-R", "1",
         "-o", str(tmp_path / "ref-"), ".csv",
         "-i", "M", "30", "0", "F", "30", "3", "-O", *streams, "-w"],
        check=True, capture_output=True,
    )
    rc = cli_main(
        ["-f", str(fn), "-s", "3", "-a", "-R", "1",
         "-o", str(tmp_path / "ours-"), ".csv",
         "-i", "M", "30", "0", "F", "30", "3", "-O", *streams, "-w"]
    )
    assert rc == 0

    seq_re = re.compile(r"^\d+:\d+(\t\d+:\d+)*$")
    for who in ("ref", "ours"):
        read = lambda s: (tmp_path / f"{who}-{s}.csv").read_text().splitlines()

        # sequences: one line per recorded sweep of SIZE:STATE tokens,
        # merged runs (adjacent states differ), sizes summing to T
        seq_lines = read("sequences")
        assert len(seq_lines) == n_rec, who
        seq_bounds = []
        for line in seq_lines:
            assert seq_re.match(line), (who, line[:80])
            toks = [tuple(map(int, t.split(":"))) for t in line.split("\t")]
            assert sum(n for n, _ in toks) == T, who
            assert all(a[1] != b[1] for a, b in zip(toks, toks[1:])), who
            seq_bounds.append(np.cumsum([n for n, _ in toks])[:-1])

        # blocks: one line per recorded sweep of tab-separated sizes
        # summing to T; compression: T / #blocks of the same sweep (the
        # reference prints it with default ostream %.6g precision)
        blk_lines = read("blocks")
        comp_lines = read("compression")
        assert len(blk_lines) == len(comp_lines) == n_rec, who
        for bl, cl in zip(blk_lines, comp_lines):
            sizes = list(map(int, bl.split("\t")))
            assert sum(sizes) == T and all(s > 0 for s in sizes), who
            assert float(cl) == float(f"{T / len(sizes):.6g}"), (who, cl)

        # parameters: (mean, var) per emission distribution, 6 decimals
        par_lines = read("parameters")
        assert len(par_lines) == n_rec, who
        for line in par_lines:
            fields = line.split("\t")
            assert len(fields) == 6, who
            assert all(re.match(r"^-?\d+\.\d{6}$", f) for f in fields), who

        # segments: nseg and store size per recorded sweep
        seg_lines = read("segments")
        assert len(seg_lines) == n_rec, who
        for line in seg_lines:
            nseg, internal = map(int, line.split("\t"))
            assert 0 < nseg <= T and internal >= nseg, who

        # marginals: the refinement partition of all recorded sweeps'
        # segmentations — every recorded sequence boundary must be a
        # marginals row boundary, rows sum to T positions and n_rec counts
        rows = [list(map(int, l.split("\t"))) for l in read("marginals")]
        assert sum(r[0] for r in rows) == T, who
        assert all(sum(r[1:]) == n_rec for r in rows), who
        marg_bounds = set(np.cumsum([r[0] for r in rows])[:-1].tolist())
        for bounds in seq_bounds:
            missing = set(bounds.tolist()) - marg_bounds
            assert not missing, (who, sorted(missing)[:5])

    def read_marginals(path):
        rows = [
            list(map(int, line.split("\t")))
            for line in open(path).read().splitlines()
        ]
        K = max(len(r) - 1 for r in rows)
        pos = np.zeros((T, K), dtype=float)
        t = 0
        for r in rows:
            pos[t : t + r[0], : len(r) - 1] = r[1:]
            t += r[0]
        return pos / pos.sum(axis=1, keepdims=True)

    ref = read_marginals(tmp_path / "ref-marginals.csv")
    got = read_marginals(tmp_path / "ours-marginals.csv")
    assert ref.shape == got.shape


def test_record_stream_bytes_golden(tmp_path):
    """Hand-built golden case for the per-sweep stream writers: exact CSV
    bytes per the reference grammar (Records.hpp:155-235 — sequences merge
    adjacent equal-state blocks into tab-joined SIZE:STATE tokens; blocks
    are tab-joined sizes; compression is T/#blocks at %.6g), and the
    native batch formatters must be byte-identical to the Python
    fallback."""
    from hammlet_tpu.io.records import Records
    from hammlet_tpu import native

    T = 20
    states = np.array([[0, 0, 1, 2, 2, 0], [1, 1, 1, 1, 1, 0]], np.int32)
    sizes = np.array([[5, 3, 2, 4, 6, 0], [2, 2, 2, 2, 12, 0]], np.int32)
    ns = np.array([5, 5], np.int64)
    n_bounds = np.array([2, 2], np.int64)

    def write(prefix):
        rec = Records(
            T, str(tmp_path / prefix), ".csv", 3,
            outputs={"sequences", "blocks", "compression", "segments"},
            overwrite=True,
        )
        rec.record_sweeps_batch(states, sizes, ns, n_bounds)
        rec.close()

    write("g-")
    assert (tmp_path / "g-sequences.csv").read_text() == (
        "8:0\t2:1\t10:2\n2:1\t2:1\t2:1\t2:1\t12:1\n".replace(
            "2:1\t2:1\t2:1\t2:1\t12:1", "20:1"
        )
    ), "adjacent equal-state blocks must merge into one segment"
    assert (tmp_path / "g-blocks.csv").read_text() == "5\t3\t2\t4\t6\n2\t2\t2\t2\t12\n"
    assert (tmp_path / "g-compression.csv").read_text() == "4\n4\n"
    # nseg = n_boundaries + 1; internal = nseg * (K + 1)
    assert (tmp_path / "g-segments.csv").read_text() == "3\t12\n3\t12\n"

    if native.available():
        import hammlet_tpu.native as nat

        orig = nat.available
        nat.available = lambda: False
        try:
            write("p-")
        finally:
            nat.available = orig
        for s in ("sequences", "blocks", "compression", "segments"):
            assert (tmp_path / f"g-{s}.csv").read_bytes() == (
                tmp_path / f"p-{s}.csv"
            ).read_bytes(), s


def test_multivariate_engine(tmp_path):
    """-s C 2 2 equivalent: 2 emission params x 2 data dims -> 4 states
    (main.cpp:117-137, Mapping.hpp:91-108)."""
    rng = np.random.default_rng(11)
    T = 1600
    means = np.array([[0.0, 0.0], [0.0, 4.0], [4.0, 0.0], [4.0, 4.0]])
    states = np.repeat(np.array([0, 1, 2, 3, 1, 0]), T // 6 + 1)[:T]
    data = means[states] + rng.normal(0, 0.8, size=(T, 2))
    rec = Records(T, str(tmp_path / "mv-"), ".csv", 4, overwrite=True)
    eng = make_engine(
        data.astype(np.float32), nr_params=2, nr_data_dim=2, seed=3, records=rec
    )
    assert eng.spec.nr_states == 4
    eng.run_scheme("M 40 0 F 60 3".split())
    eng.finalize()
    rows = [
        list(map(int, l.split("\t")))
        for l in (tmp_path / "mv-marginals.csv").read_text().splitlines()
    ]
    assert sum(r[0] for r in rows) == T
    # marginals have up to 4 state columns; recover the segmentation
    pos = np.zeros(T, dtype=int)
    t = 0
    for r in rows:
        c = r[1:] + [0] * (4 - len(r) + 1)
        pos[t : t + r[0]] = int(np.argmax(c))
        t += r[0]
    agree = 0
    for s in range(4):
        m = pos == s
        if m.sum():
            agree += (states[m] == np.bincount(states[m], minlength=4).argmax()).sum()
    assert agree / T > 0.95


def test_static_scheme_freezes_blocks(tmp_path):
    """The S token freezes the block structure: identical block lines every
    recorded sweep (main.cpp:407-421; verified reference behavior,
    SURVEY.md §7)."""
    data, _, _ = synth_data(T=1500, seed=8)
    rec = Records(
        len(data), str(tmp_path / "st-"), ".csv", 3,
        outputs={"blocks", "compression", "marginals"}, overwrite=True,
    )
    eng = make_engine(data, nr_params=3, seed=2, records=rec)
    eng.run_scheme("M 30 0 S F 10 1".split())
    eng.finalize()
    lines = (tmp_path / "st-blocks.csv").read_text().splitlines()
    assert len(lines) == 10
    assert len(set(lines)) == 1  # frozen structure
    comp = set((tmp_path / "st-compression.csv").read_text().split())
    assert len(comp) == 1


def test_device_ingest_path(tmp_path):
    """The device-side ingest (upload raw data only; transform/sort/prefix on
    the accelerator) produces equivalent results to the host path."""
    data, true_states, _ = synth_data(T=2200, seed=21)
    rec = Records(len(data), str(tmp_path / "di-"), ".csv", 3, overwrite=True)
    eng = make_engine(data, nr_params=3, seed=7, records=rec, device_ingest=True)
    assert eng.ing.weights_host is None  # device path active
    eng.run_scheme("M 60 0 F 40 4".split())
    eng.finalize()
    rows = [
        list(map(int, l.split("\t")))
        for l in (tmp_path / "di-marginals.csv").read_text().splitlines()
    ]
    T = len(data)
    assert sum(r[0] for r in rows) == T
    for r in rows:
        assert sum(r[1:]) == 10
    pos = np.zeros(T, dtype=int)
    t = 0
    for r in rows:
        pos[t : t + r[0]] = int(np.argmax(r[1:]))
        t += r[0]
    agree = 0
    for s in range(3):
        m = pos == s
        if m.sum():
            agree += (true_states[m] == np.bincount(true_states[m], minlength=3).argmax()).sum()
    assert agree / T > 0.97

    # maxlet/weights on device are bit-identical to the host/native path
    from hammlet_tpu.runner import host_transform

    _, _, w_host = host_transform(data[:, None] if data.ndim == 1 else data)
    import jax.numpy as jnp
    neg_sorted_host = np.sort(-w_host)
    np.testing.assert_array_equal(
        np.asarray(eng.ing.ranked.neg_w_sorted), neg_sorted_host
    )
