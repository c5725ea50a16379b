"""The port's scaffolding commands — `solve_dbg` (-unphase, -divide_only,
the default phasing flow, -x tags), `scaffold`, `consensus` and `divide` —
against the JAX package, every written file byte for byte. Both CLIs run
on the CPU, each in a directory of its own that holds the same inputs,
with the same relative paths and the same -o prefix, so output names,
headers and intermediate directories agree without renaming
(`run_both`, also used by tests/test_torch_iterate.py).
"""

import torch_threads  # noqa: F401  (first: sets torch's CPU threads)

import pathlib
import shutil

import numpy as np
import pytest

import simdata
from platanus_b_tpu.commands.main import main as jax_main
from platanus_b_tpu_torch.commands.main import main as port_main

LIB = ["-IP1", "1.fa", "2.fa"]


def _tree(d: pathlib.Path) -> dict:
    return {str(p.relative_to(d)): p.read_bytes()
            for p in sorted(d.rglob("*")) if p.is_file()}


def run_both(src: pathlib.Path, work: pathlib.Path, monkeypatch, argv,
             inputs) -> dict:
    """Copy `inputs` (names in `src`) into work/jax and work/port, run argv
    from each, and assert that both exit 0 and write the same files.
    Returns {relative path: bytes} of what the JAX run wrote."""
    monkeypatch.setenv("PLATANUS_B_TPU_TORCH_DEVICE", "cpu")
    written = {}
    for side, main in (("jax", jax_main), ("port", port_main)):
        d = work / side
        d.mkdir(parents=True)
        for name in inputs:
            shutil.copyfile(src / name, d / name)
        before = set(_tree(d))
        monkeypatch.chdir(d)
        assert main(list(argv)) == 0, side
        written[side] = {n: b for n, b in _tree(d).items() if n not in before}
    assert sorted(written["port"]) == sorted(written["jax"])
    for name, want in written["jax"].items():
        assert written["port"][name] == want, name
    return written["jax"]


@pytest.fixture(scope="module")
def pe(tmp_path_factory):
    """tests/test_scaffold_cmd.py's data: an 8 kbp genome in two contigs
    with a 200 bp gap, 30x innie pairs (insert 500); plus the same pairs
    interleaved as a tagged (BX:Z:) FASTQ, one barcode per 1 kbp window of
    the fragment start."""
    d = tmp_path_factory.mktemp("pe")
    rng = np.random.default_rng(42)
    genome = simdata.random_genome(rng, 8000)
    contigs = [genome[:3900], genome[4100:]]
    with open(d / "c.fa", "w") as f:
        for i, c in enumerate(contigs):
            f.write(f">seq{i+1}_len{len(c)}_cov40_read100_maxK50\n{c}\n")
    fwd, rev = simdata.paired_reads(rng, genome, read_len=100, insert=500,
                                    sd=50, coverage=30.0)
    simdata.write_fasta(d / "1.fa", fwd)
    simdata.write_fasta(d / "2.fa", rev)
    with open(d / "x.fq", "w") as f:
        for i, (r1, r2) in enumerate(zip(fwd, rev)):
            pos = genome.find(r1)
            bc = "ACGT"[max(pos, 0) // 1000 % 4] * 8
            for end, r in ((1, r1), (2, r2)):
                f.write(f"@p{i}/{end} BX:Z:{bc}-1\n{r}\n+\n{'I' * len(r)}\n")
    return d


@pytest.fixture(scope="module")
def hap(tmp_path_factory):
    """tests/test_phase.py:50's data: a 25 kbp homozygous contig and two
    12 kbp haplotigs 0.3% apart, at coverages 40, 21 and 19; no reads."""
    d = tmp_path_factory.mktemp("hap")
    rng = np.random.default_rng(42)
    homo = simdata.random_genome(rng, 25000)
    hap1 = simdata.random_genome(rng, 12000)
    hap2 = simdata.mutate(rng, hap1, 0.003)
    with open(d / "c.fa", "w") as f:
        f.write(f">seq1_len{len(homo)}_cov40_read100_maxK50\n{homo}\n")
        f.write(f">seq2_len{len(hap1)}_cov21_read100_maxK50\n{hap1}\n")
        f.write(f">seq3_len{len(hap2)}_cov19_read100_maxK50\n{hap2}\n")
    return d


@pytest.mark.parametrize("flags", [
    ["-unphase"], ["-unphase", "-reduce_redundancy"],
    ["-unphase", "-trim_overlap"], ["-divide_only"],
    ["-unphase", "-x", "x.fq"]], ids=lambda f: "".join(f))
def test_solve_dbg_cli_byte_identical(pe, tmp_path, monkeypatch, flags):
    wrote = run_both(pe, tmp_path, monkeypatch,
                     ["solve_dbg"] + flags + ["-c", "c.fa", "-o", "out"]
                     + LIB, ["c.fa", "1.fa", "2.fa", "x.fq"])
    if "-divide_only" in flags:
        assert "out_divided.fa" in wrote
    else:
        # the pairs across the gap join the two contigs into one scaffold
        assert wrote["out_consensusScaffold.fa"].count(b">") == 1


def test_solve_dbg_phasing_flow_byte_identical(hap, tmp_path, monkeypatch):
    """The default flow pairs the haplotigs (phasing.py's containment
    pairing, through the port's asm10 long-read aligner)."""
    wrote = run_both(hap, tmp_path, monkeypatch,
                     ["solve_dbg", "-c", "c.fa", "-o", "out"], ["c.fa"])
    assert wrote["out_primaryBubble.fa"].count(b">") == 1
    assert wrote["out_secondaryBubble.fa"].count(b">") == 1


def test_solve_dbg_phasing_flow_tags_byte_identical(pe, tmp_path,
                                                    monkeypatch):
    """The default flow with a PE library and a tagged library (-x)."""
    wrote = run_both(pe, tmp_path, monkeypatch,
                     ["solve_dbg", "-c", "c.fa", "-o", "out", "-x", "x.fq"]
                     + LIB, ["c.fa", "1.fa", "2.fa", "x.fq"])
    assert "out_phasedScaffoldComponent.bed" in wrote


@pytest.mark.parametrize("flags", [[], ["-fastg"]], ids=["plain", "fastg"])
def test_scaffold_cli_byte_identical(pe, tmp_path, monkeypatch, flags):
    wrote = run_both(pe, tmp_path, monkeypatch,
                     ["scaffold", "-o", "out", "-c", "c.fa"] + flags + LIB,
                     ["c.fa", "1.fa", "2.fa"])
    if flags:
        # -fastg dumps each library's graph edges and does not scaffold
        assert list(wrote) == ["out_lib1_graph.fastg"]
        assert wrote["out_lib1_graph.fastg"]
    else:
        assert wrote["out_scaffold.fa"].count(b">") == 1


@pytest.mark.parametrize("cmd", ["consensus", "divide"])
def test_consensus_and_divide_cli_byte_identical(pe, tmp_path, monkeypatch,
                                                 cmd):
    wrote = run_both(pe, tmp_path, monkeypatch,
                     [cmd, "-o", "out", "-c", "c.fa"] + LIB,
                     ["c.fa", "1.fa", "2.fa"])
    assert wrote
