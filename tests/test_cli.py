"""CLI parser hardening + flag-effect tests (Parser.hpp:142-269 parity).

The reference registers every flag and errors on duplicates / leading
positionals; this front end additionally rejects unknown '-x' tokens up
front (PARITY.md). The flag-effect tests prove -t/-I/-m/-S/-e values
actually reach the model instead of being silently swallowed."""

import numpy as np
import pytest

from hammlet_tpu.cli import main as cli_main, parse_args


def synth(tmp_path, T=1200, seed=3):
    rng = np.random.default_rng(seed)
    d = np.concatenate(
        [rng.normal(0, 1, T // 3), rng.normal(5, 1, T // 3),
         rng.normal(0, 1, T - 2 * (T // 3))]
    )
    f = tmp_path / "d.csv"
    np.savetxt(f, d)
    return str(f)


# ---- parser ---------------------------------------------------------------

def test_unknown_flag_rejected(tmp_path, capsys):
    f = synth(tmp_path)
    rc = cli_main(["-f", f, "-s", "3", "-q", "-i", "F", "10", "1"])
    assert rc == 1
    assert "Unknown flag -q!" in capsys.readouterr().err
    assert not (tmp_path / "d-marginals.csv").exists()


def test_duplicate_flag_rejected(capsys):
    rc = cli_main(["-s", "3", "-s", "4"])
    assert rc == 1
    assert "Duplicate flag -s!" in capsys.readouterr().err


def test_positional_first_rejected(capsys):
    rc = cli_main(["data.csv"])
    assert rc == 1
    assert "not a registered flag" in capsys.readouterr().err


def test_negative_numbers_are_values():
    args = parse_args(["-t", "-0.5", "-m", "-2"])
    assert args["-t"] == ["-0.5"]
    assert args["-m"] == ["-2"]


def test_aliases_and_conversion_errors(capsys):
    args = parse_args(["-input-file", "x", "-random-seed", "11"])
    assert args["-f"] == ["x"] and args["-R"] == ["11"]
    rc = cli_main(["-R", "eleven", "-a"])
    assert rc == 1
    assert 'Conversion failed for string "eleven"!' in capsys.readouterr().err


def test_conversion_errors_cover_D_and_C(tmp_path, capsys):
    """-D and -C EVERY go through the same typed-parse layer as every
    other numeric flag (Parser.hpp:46-54 error text)."""
    f = synth(tmp_path)
    rc = cli_main(["-f", f, "-a", "-D", "two", "-i", "F", "2", "0", "-w",
                   "-o", str(tmp_path / "d-"), ".csv"])
    assert rc == 1
    assert 'Conversion failed for string "two"!' in capsys.readouterr().err
    rc = cli_main(["-f", f, "-a", "-C", str(tmp_path / "ck.npz"), "often",
                   "-i", "F", "2", "0", "-w",
                   "-o", str(tmp_path / "c-"), ".csv"])
    assert rc == 1
    assert 'Conversion failed for string "often"!' in capsys.readouterr().err


def test_missing_arguments_error(tmp_path, capsys):
    f = synth(tmp_path)
    rc = cli_main(["-f", f, "-a", "-e", "normal", "0.2"])  # p missing
    assert rc == 1
    assert "Not enough arguments for flag -e!" in capsys.readouterr().err


def test_arguments_dump_format(tmp_path, capsys):
    f = synth(tmp_path)
    rc = cli_main(["-f", f, "-g", "-R", "4", "-i", "F", "2", "0", "-a",
                   "-O", "compression", "-w"])
    assert rc == 0
    out = capsys.readouterr().out
    # reference format: "[*] -R -random-seed : 4" / unset "[ ] -s -states : 3"
    assert any(
        l.startswith("[*]") and "-R" in l and l.rstrip().endswith(": 4")
        for l in out.splitlines()
    )
    assert any(
        l.startswith("[ ]") and "-states" in l and l.rstrip().endswith(": 3")
        for l in out.splitlines()
    )


# ---- flag effects ----------------------------------------------------------

def _params_after(tmp_path, f, extra, tag):
    argv = ["-f", f, "-o", str(tmp_path / f"{tag}-"), ".csv", "-s", "2",
            "-a", "-R", "3", "-i", "M", "5", "0", "F", "5", "5",
            "-O", "parameters", "-w"] + extra
    assert cli_main(argv) == 0
    row = (tmp_path / f"{tag}-parameters.csv").read_text().strip().splitlines()[-1]
    return np.array([float(x) for x in row.split("\t")])


def test_flags_reach_the_engine(tmp_path, monkeypatch):
    """-t/-I/-m/-S/-e values are wired through to the model construction
    (the reference reads them in main.cpp:117-215)."""
    import hammlet_tpu.cli as cli
    from hammlet_tpu.runner import make_engine

    f = synth(tmp_path)
    seen = {}

    def spy(data, **kw):
        seen.update(kw)
        return make_engine(data, **kw)

    monkeypatch.setattr(cli, "make_engine", spy)
    argv = ["-f", f, "-o", str(tmp_path / "w-"), ".csv", "-s", "2", "-a",
            "-R", "3", "-i", "F", "2", "0", "-w",
            "-t", "9.0", "0.125", "-I", "17.0", "-m", "4.0", "-S",
            "-e", "normal", "3.0", "0.5"]
    assert cli.main(argv) == 0
    assert seen["trans"] == 9.0 and seen["self_trans"] == 0.125
    assert seen["initial_alpha"] == 17.0
    assert seen["weight_multiplier"] == 4.0
    assert seen["use_self_transitions"] is False
    assert seen["s2"] == 3.0 and seen["p"] == 0.5
    # -t with one value: diagonal defaults to the off-diagonal value
    seen.clear()
    argv2 = ["-f", f, "-o", str(tmp_path / "w2-"), ".csv", "-s", "2", "-a",
             "-R", "3", "-i", "F", "2", "0", "-w", "-t", "2.5"]
    assert cli.main(argv2) == 0
    assert seen["trans"] == 2.5 and seen["self_trans"] == 2.5


def test_flags_change_sampled_parameters(tmp_path):
    f = synth(tmp_path)
    base = _params_after(tmp_path, f, [], "base")
    # same seed, same scheme: strong-effect flags must change the sampled
    # parameters (-m rescales the compression threshold, -e the priors)
    for extra, tag in [
        (["-m", "4.0"], "m"),
        (["-e", "normal", "3.0", "0.5"], "e"),
    ]:
        other = _params_after(tmp_path, f, extra, tag)
        assert not np.array_equal(base, other), f"{tag} had no effect"
    # and the baseline itself is reproducible
    again = _params_after(tmp_path, f, [], "base2")
    np.testing.assert_array_equal(base, again)


def test_seed_changes_run(tmp_path):
    f = synth(tmp_path)
    a = _params_after(tmp_path, f, [], "sa")
    argv_b = ["-f", f, "-o", str(tmp_path / "sb-"), ".csv", "-s", "2", "-a",
              "-R", "4", "-i", "M", "5", "0", "F", "5", "5",
              "-O", "parameters", "-w"]
    assert cli_main(argv_b) == 0
    b = np.array([
        float(x)
        for x in (tmp_path / "sb-parameters.csv")
        .read_text().strip().splitlines()[-1].split("\t")
    ])
    assert not np.array_equal(a, b)


def test_multi_chain_device_parallel(tmp_path, monkeypatch):
    """-M chains are device-parallel: each chain is pinned to its own local
    device and runs concurrently (thread-local default_device; on N real
    devices N chromosomes then finish in ~the time of one — the CPU test
    backend shares a few host cores among all 8 virtual devices, so the
    test asserts
    genuine concurrency + placement + byte-identity to sequential, not a
    wall-clock ratio)."""
    import time

    import jax

    import hammlet_tpu.cli as cli

    rng = np.random.default_rng(2)
    files = []
    for i in range(3):
        f = tmp_path / f"chr{i+1}.csv"
        np.savetxt(
            f,
            np.concatenate(
                [rng.normal(0, 1, 2000), rng.normal(5, 1, 2000)]
            ),
        )
        files.append(str(f))

    intervals, devices_used = [], []
    real_run = cli._run

    def spy(sub):
        if "-M" in sub:  # the dispatcher call itself, not a chain
            return real_run(sub)
        t0 = time.time()
        devices_used.append(jax.config.jax_default_device)
        rc = real_run(sub)
        intervals.append((t0, time.time()))
        return rc

    monkeypatch.setattr(cli, "_run", spy)
    base = ["-s", "2", "-a", "-R", "3", "-i", "M", "10", "0", "F", "20", "2",
            "-O", "marginals", "parameters", "-w", "-M", "-f", *files]
    assert cli.main(["-o", str(tmp_path / "par-"), ".csv", *base]) == 0
    # each chain ran under a distinct pinned device
    assert len({str(d) for d in devices_used}) == 3, devices_used
    # chains genuinely overlapped in time
    (s0, e0), (s1, e1) = sorted(intervals)[:2]
    assert max(s0, s1) < min(e0, e1), intervals

    # sequential (-D present forces it): outputs byte-identical
    intervals.clear()
    devices_used.clear()
    assert cli.main(
        ["-o", str(tmp_path / "seq-"), ".csv", "-D", "1", *base]
    ) == 0
    for i in range(3):
        for s in ("marginals", "parameters"):
            a = (tmp_path / f"par-chr{i+1}-{s}.csv").read_text()
            b = (tmp_path / f"seq-chr{i+1}-{s}.csv").read_text()
            assert a == b, (i, s)


def test_multi_sequence_independent_chains(tmp_path):
    """-M: each -f file is an independent chain with its own outputs
    (the reference's per-chromosome workflow, bin/samToCounts:5-7)."""
    rng = np.random.default_rng(0)
    fa = tmp_path / "chr1.csv"
    fb = tmp_path / "chr2.csv"
    np.savetxt(fa, np.concatenate([rng.normal(0, 1, 400), rng.normal(5, 1, 400)]))
    np.savetxt(fb, np.concatenate([rng.normal(5, 1, 300), rng.normal(0, 1, 500)]))
    rc = cli_main(
        ["-f", str(fa), str(fb), "-M", "-s", "2", "-a", "-R", "3",
         "-o", str(tmp_path / "wgs-"), ".csv",
         "-i", "M", "5", "0", "F", "5", "1", "-O", "marginals", "-w"]
    )
    assert rc == 0
    for stem, T in (("chr1", 800), ("chr2", 800)):
        rows = [
            list(map(int, l.split("\t")))
            for l in (tmp_path / f"wgs-{stem}-marginals.csv").read_text().splitlines()
        ]
        assert sum(r[0] for r in rows) == T
        assert all(sum(r[1:]) == 5 for r in rows)
    # the two chains are genuinely independent: chr1's marginals match a
    # solo run on the same file with the same seed
    rc = cli_main(
        ["-f", str(fa), "-s", "2", "-a", "-R", "3",
         "-o", str(tmp_path / "solo-"), ".csv",
         "-i", "M", "5", "0", "F", "5", "1", "-O", "marginals", "-w"]
    )
    assert rc == 0
    assert (
        (tmp_path / "wgs-chr1-marginals.csv").read_text()
        == (tmp_path / "solo-marginals.csv").read_text()
    )


def test_mapping_output(tmp_path):
    """-O D writes the state -> emission-parameter mapping (one row per
    state, one parameter index per data dimension). Upstream registers the
    flag (main.cpp:244) but its handler is an empty TODO (main.cpp:249-252);
    we implement the documented intent, including the overwrite guard."""
    rng = np.random.default_rng(0)
    T = 600
    d = np.column_stack([rng.normal(0, 1, T), rng.normal(2, 1, T)])
    f = tmp_path / "mv.csv"
    np.savetxt(f, d)
    argv = ["-f", str(f), "-o", str(tmp_path / "map-"), ".csv",
            "-s", "C", "2", "2", "-a", "-R", "1", "-i", "F", "2", "0",
            "-O", "M", "D", "-w"]
    assert cli_main(argv) == 0
    out = (tmp_path / "map-mapping.csv").read_text().splitlines()
    # combinations scheme: K = 2^2 states, reversed base-2 digits
    assert out == ["0\t0", "1\t0", "0\t1", "1\t1"]
    from hammlet_tpu.models.mapping import combinations_mapping

    expect = combinations_mapping(2, 2)
    got = np.array([[int(x) for x in line.split("\t")] for line in out])
    np.testing.assert_array_equal(got, expect)
    from hammlet_tpu.pyhammlet.io import readMapping

    np.testing.assert_array_equal(
        readMapping(tmp_path / "map-mapping.csv"), expect
    )
    # marginals still written alongside
    assert (tmp_path / "map-marginals.csv").exists()
    # overwrite guard applies to the mapping stream too
    rc = cli_main([a for a in argv if a != "-w"])
    assert rc == 1
