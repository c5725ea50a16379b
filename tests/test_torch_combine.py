"""`combine`, `solve_dbg -combine` and models/combinatorial.py in the port
against the JAX package: the functions on tests/test_combinatorial.py's
inputs, whole, and the commands on tests/test_combinatorial.py's and
tests/test_combine_cmd.py's data, every written file byte for byte
(run_both, tests/test_torch_solve_dbg.py). Also the CLI's answer to an
unknown command.
"""

import torch_threads  # noqa: F401  (first: sets torch's CPU threads)

import numpy as np
import pytest

import simdata
from platanus_b_tpu.commands.main import main as jax_main
from platanus_b_tpu.io.fasta import seq_to_codes
from platanus_b_tpu.models import combinatorial as jcomb
from platanus_b_tpu_torch.commands.main import main as port_main
from platanus_b_tpu_torch.models import combinatorial as tcomb
from test_torch_solve_dbg import run_both


@pytest.mark.parametrize("flank_len", [100, 500, 1000])
def test_extract_gap_flanks_equal(flank_len):
    """tests/test_combinatorial.py:10-18's sequence, and one with a short
    contig run between two N gaps."""
    rng = np.random.default_rng(42)
    g = simdata.random_genome(rng, 3000)
    seqs = [seq_to_codes(g[:1400] + "N" * 100 + g[1500:]),
            seq_to_codes(g[:900] + "N" * 50 + g[950:1300] + "N" * 20
                         + g[1320:])]
    want = jcomb.extract_gap_flanks(seqs, ["x", "y"], flank_len)
    got = tcomb.extract_gap_flanks(seqs, ["x", "y"], flank_len)
    assert [n for n, _ in got] == [n for n, _ in want]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(got, want))
    assert want


def test_combinatorial_gap_close_equal(monkeypatch):
    """tests/test_combinatorial.py:21-31: a 500 bp N gap closed from a
    complement that spans it."""
    monkeypatch.setenv("PLATANUS_B_TPU_TORCH_DEVICE", "cpu")
    rng = np.random.default_rng(42)
    genome = simdata.random_genome(rng, 30000)
    base = seq_to_codes(genome[:14000] + "N" * 500 + genome[14800:])
    compl = seq_to_codes(genome[9000:21000])
    args = ([base], ["base1_len30000"], [compl], ["comp1"])
    want, wn = jcomb.combinatorial_gap_close(*args,
                                             flank_lengths=(500, 1000, 5000))
    got, gn = tcomb.combinatorial_gap_close(*args,
                                            flank_lengths=(500, 1000, 5000))
    assert gn == wn >= 1
    assert len(got) == len(want)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert "".join("ACGTN"[b] for b in got[0]) == genome


def test_remove_redundant_equal(monkeypatch):
    """tests/test_combinatorial.py:34-41."""
    monkeypatch.setenv("PLATANUS_B_TPU_TORCH_DEVICE", "cpu")
    rng = np.random.default_rng(42)
    genome = simdata.random_genome(rng, 20000)
    seqs = [seq_to_codes(genome), seq_to_codes(genome[4000:12000]),
            seq_to_codes(simdata.random_genome(rng, 9000))]
    names = ["full", "contained", "other"]
    want = jcomb.remove_redundant(seqs, names)
    assert tcomb.remove_redundant(seqs, names) == want == [False, True, False]


@pytest.fixture(scope="module")
def junction(tmp_path_factory):
    """tests/test_combinatorial.py:68-79's data: a 60 kbp genome in two
    pieces with 1 kbp missing between them, and a guide assembly over the
    junction."""
    d = tmp_path_factory.mktemp("junction")
    rng = np.random.default_rng(42)
    genome = simdata.random_genome(rng, 60000)
    with open(d / "c.fa", "w") as f:
        for i, c in enumerate([genome[:29000], genome[30000:]]):
            f.write(f">seq{i+1}_len{len(c)}_cov40_read100_maxK50\n{c}\n")
    with open(d / "g.fa", "w") as f:
        f.write(f">g1_len40000_cov40\n{genome[10000:50000]}\n")
    return d


def test_solve_dbg_combine_byte_identical(junction, tmp_path, monkeypatch):
    wrote = run_both(junction, tmp_path, monkeypatch,
                     ["solve_dbg", "-combine", "-o", "out", "-c", "c.fa",
                      "-gc", "g.fa"], ["c.fa", "g.fa"])
    scaffolds = wrote["out_combined.fa"].split(b">")[1:]
    assert max(len(s) for s in scaffolds) > 55000


def _combine_data(d, rng, gap_close: bool):
    """tests/test_combine_cmd.py's two data sets."""
    if gap_close:
        genome = simdata.random_genome(rng, 60000)
        piece1 = genome[:24000] + "N" * 400 + genome[24500:29000]
        pieces = [piece1, genome[30000:]]
        guide = genome[5000:55000]
    else:
        genome = simdata.random_genome(rng, 40000)
        pieces = [genome[:19000], genome[20500:]]
        guide = genome[5000:35000]
    with open(d / "c.fa", "w") as f:
        for i, p in enumerate(pieces):
            f.write(f">seq{i+1}_len{len(p)}_cov40_read100_maxK50\n{p}\n")
    with open(d / "g.fa", "w") as f:
        f.write(f">g1_len{len(guide)}_cov40\n{guide}\n")


@pytest.mark.parametrize("flags", [[], ["-no_gap_close", "-keep_file"]],
                         ids=["gap_close", "no_gap_close"])
def test_combine_command_byte_identical(tmp_path, monkeypatch, flags):
    src = tmp_path / "src"
    src.mkdir()
    _combine_data(src, np.random.default_rng(42), not flags)
    wrote = run_both(src, tmp_path, monkeypatch,
                     ["combine", "-o", "out", "-c", "c.fa", "-gc", "g.fa"]
                     + flags, ["c.fa", "g.fa"])
    longest = max(wrote["out_combined.fa"].split(b">")[1:], key=len)
    if flags:
        assert "out_combineIntermediateResults/out_combined.fa" in wrote
    else:
        assert list(wrote) == ["out_combined.fa"]
        assert len(longest) > 50000 and b"N" not in longest.split(b"\n", 1)[1]


@pytest.mark.parametrize("main", [jax_main, port_main], ids=["jax", "port"])
def test_unknown_command_exits_2(main, capsys):
    """Both CLIs leave an unknown command to argparse: usage and exit 2."""
    with pytest.raises(SystemExit) as e:
        main(["foo"])
    assert e.value.code == 2
    assert "invalid choice: 'foo'" in capsys.readouterr().err
