"""L8 tail: oracle tests vs the compiled reference genome tools, the
sortMultiplyAndCompress equivalent, and the plotResults subfigure grammar."""

import gzip
import os
import subprocess
import sys

import numpy as np
import pytest

from hammlet_tpu.tools.genome import (
    combine_counts_main,
    map_lines_to_genome_main,
    sort_multiply_and_compress,
)

REF_TOOLS = "/root/reference/src/tools"
GZS = "/root/reference/lib/gzstream"


@pytest.fixture(scope="module")
def ref_tool(tmp_path_factory):
    """Compile a reference genome tool (with gzstream) on demand."""
    d = tmp_path_factory.mktemp("reftools")

    def build(name):
        out = d / name
        if out.exists():
            return str(out)
        r = subprocess.run(
            ["g++", "-O2", "--std=c++11", "-include", "limits",
             "-o", str(out), f"{REF_TOOLS}/{name}.cpp", f"{GZS}/gzstream.C",
             f"-I{GZS}", "-lz"],
            capture_output=True, text=True,
        )
        if r.returncode != 0:
            pytest.skip(f"cannot compile {name}: {r.stderr[-300:]}")
        return str(out)

    return build


def _write_count_files(d, prefix, refseqs):
    """refseqs: {name: (pos_array, cnt_array)}; writes the reference's
    3-file-per-prefix genome count representation (size rows are
    refseq\tsize\tcumulative, combineCounts.cpp:184-195)."""
    total = 0
    with open(d / f"{prefix}-size.csv", "w") as sf:
        for name, (pos, cnt) in refseqs.items():
            total += len(pos)
            sf.write(f"{name}\t{len(pos)}\t{total}\n")
    # single pos/count streams concatenated in size-file order
    with gzip.open(d / f"{prefix}-pos.csv.gz", "wt") as pf, gzip.open(
        d / f"{prefix}-count.csv.gz", "wt"
    ) as cf:
        for name, (pos, cnt) in refseqs.items():
            pf.write("\n".join(str(p) for p in pos) + "\n")
            cf.write("\n".join(str(c) for c in cnt) + "\n")


def test_sort_multiply_and_compress():
    pos = np.array([7, 3, 7, 3, 9, 3])
    val = np.array([2.0, 0.5, 3.0, 4.0, 5.0, 2.0])
    upos, uval = sort_multiply_and_compress(pos, val)
    assert upos.tolist() == [3, 7, 9]
    # duplicates multiply (MappedValues.hpp:85-102)
    np.testing.assert_allclose(uval, [0.5 * 4.0 * 2.0, 2.0 * 3.0, 5.0])


def test_combine_counts_matches_reference_tool(tmp_path, ref_tool, monkeypatch):
    binpath = ref_tool("combineCounts")

    def mkset(prefix, seed):
        rng = np.random.default_rng(seed)
        refseqs = {}
        for name in ("chr1", "chr2"):
            n = int(rng.integers(20, 60))
            pos = np.sort(rng.choice(np.arange(1, 200), size=n, replace=False))
            cnt = rng.integers(1, 9, size=n)
            refseqs[name] = (pos, cnt)
        _write_count_files(tmp_path, prefix, refseqs)

    mkset("a", 1)
    mkset("b", 2)

    subprocess.run(
        [binpath, "-i", "+", "a", "b", "-o", "ref"],
        cwd=tmp_path, check=True, capture_output=True,
    )
    monkeypatch.chdir(tmp_path)
    rc = combine_counts_main(["-i", "+", "a", "b", "-o", "ours"])
    assert rc == 0

    for suff in ("-size.csv",):
        assert (tmp_path / f"ours{suff}").read_text() == (
            tmp_path / f"ref{suff}"
        ).read_text()
    for suff in ("-pos.csv.gz", "-count.csv.gz"):
        ours = gzip.open(tmp_path / f"ours{suff}", "rt").read().split()
        want = gzip.open(tmp_path / f"ref{suff}", "rt").read().split()
        assert ours == want, suff


def test_map_lines_to_genome_matches_reference_tool(tmp_path, ref_tool, monkeypatch):
    binpath = ref_tool("mapLinesToGenome")
    rng = np.random.default_rng(9)
    refseqs = {}
    total = 0
    for name in ("chr1", "chr2"):
        n = int(rng.integers(10, 30))
        pos = np.sort(rng.choice(np.arange(1, 500), size=n, replace=False))
        cnt = rng.integers(1, 5, size=n)
        refseqs[name] = (pos, cnt)
        total += n
    _write_count_files(tmp_path, "g", refseqs)
    lines = "\n".join(f"v{i}" for i in range(total)) + "\n"
    (tmp_path / "lines.txt").write_text(lines)

    want = subprocess.run(
        [binpath, "-g", "g"], input=lines, cwd=tmp_path,
        capture_output=True, text=True, check=True,
    ).stdout
    monkeypatch.chdir(tmp_path)
    (tmp_path / "in.txt").write_text(lines)
    rc = map_lines_to_genome_main(["-g", "g", "-i", "in.txt", "-o", "out.txt"])
    assert rc == 0
    assert (tmp_path / "out.txt").read_text() == want

    # -r range form and -c coordinate form also match the binary
    for extra in (["-r"], ["-c"], ["-r", "-c"]):
        want = subprocess.run(
            [binpath, "-g", "g"] + extra, input=lines, cwd=tmp_path,
            capture_output=True, text=True, check=True,
        ).stdout
        rc = map_lines_to_genome_main(
            ["-g", "g", "-i", "in.txt", "-o", "out.txt"] + extra
        )
        assert rc == 0
        assert (tmp_path / "out.txt").read_text() == want, extra


def test_plot_results_subfigure_grammar(tmp_path):
    """End-to-end plotResults run over real record streams with the
    reference's -s grammar, range and split options (bin/plotResults)."""
    from hammlet_tpu.cli import main as cli_main
    from hammlet_tpu.tools.plot_results import main as plot_main

    rng = np.random.default_rng(2)
    data = np.concatenate([rng.normal(0, 1, 300), rng.normal(5, 1, 300)])
    f = tmp_path / "d.csv"
    np.savetxt(f, data)
    rc = cli_main(
        ["-f", str(f), "-s", "2", "-a", "-R", "1",
         "-i", "M", "5", "0", "F", "6", "2",
         "-O", "marginals", "sequences", "blocks", "-w"]
    )
    assert rc == 0
    rc = plot_main(
        ["-f", str(f), "-s", "Ym", "Msp", "S", "B",
         "-y", "Data", "Marginals", "Sequences", "Blocks",
         "-r", "50", "-d", "6", "6"]
    )
    assert rc == 0
    assert (tmp_path / "d-0-599.png").stat().st_size > 0
    # split + range + count-scaled frequency-sorted marginals
    rc = plot_main(
        ["-f", str(f), "-s", "Mfc", "-S", "250", "-R", "0", "500",
         "-r", "40"]
    )
    assert rc == 0
    assert (tmp_path / "d-0-249.png").exists()
    assert (tmp_path / "d-250-499.png").exists()
    # invalid descriptors fail like the reference
    with pytest.raises(SystemExit):
        plot_main(["-f", str(f), "-s", "ym"])  # no capital
    with pytest.raises(SystemExit):
        plot_main(["-f", str(f), "-s", "M"])  # missing sort/scale letters


def test_matrix_quantile_plot(tmp_path):
    import matplotlib.pyplot as plt

    from hammlet_tpu.pyhammlet.plotting import matrixQuantilePlot

    rng = np.random.default_rng(0)
    data = rng.normal(0, 1, size=(200, 50)) + np.linspace(0, 3, 50)
    plt.figure()
    ax = matrixQuantilePlot(data, ylabel="F-measure (quantiles)")
    out = tmp_path / "q.png"
    plt.savefig(out, dpi=40)
    plt.close()
    assert out.stat().st_size > 0
    assert ax.get_ylabel() == "F-measure (quantiles)"
