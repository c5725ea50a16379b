"""`iterate -i 1` and `phase` in the port against the JAX package, every
written file byte for byte (run_both, tests/test_torch_solve_dbg.py). The
long-read and later-round paths are in tests/test_torch_longread_cli.py
and tests/test_torch_combine.py.
"""

import torch_threads  # noqa: F401  (first: sets torch's CPU threads)

import numpy as np
import pytest

import simdata
from test_torch_solve_dbg import run_both


@pytest.fixture(scope="module")
def frag(tmp_path_factory):
    """tests/test_iterate.py:12-23's data: an 8 kbp genome in three
    contigs with 200 bp gaps, 40x innie pairs (insert 500, 0.2% errors)."""
    d = tmp_path_factory.mktemp("frag")
    rng = np.random.default_rng(42)
    genome = simdata.random_genome(rng, 8000)
    contigs = [genome[0:2500], genome[2700:5200], genome[5400:8000]]
    with open(d / "start_contig.fa", "w") as f:
        for i, c in enumerate(contigs):
            f.write(f">seq{i+1}_len{len(c)}_cov40_read100_maxK32\n{c}\n")
    fwd, rev = simdata.paired_reads(rng, genome, read_len=100, insert=500,
                                    sd=50, coverage=40.0, error_rate=0.002)
    simdata.write_fasta(d / "r1.fa", fwd)
    simdata.write_fasta(d / "r2.fa", rev)
    return d


@pytest.fixture(scope="module")
def diploid(tmp_path_factory):
    """tests/test_phase.py:77's data: a 16 kbp homozygous contig and two
    8 kbp haplotigs 0.4% apart; 30x innie pairs from each haplotype."""
    d = tmp_path_factory.mktemp("diploid")
    rng = np.random.default_rng(42)
    homo = simdata.random_genome(rng, 16000)
    het1 = simdata.random_genome(rng, 8000)
    het2 = simdata.mutate(rng, het1, 0.004)
    with open(d / "c.fa", "w") as f:
        f.write(f">seq1_len{len(homo)}_cov40_read100_maxK50\n{homo}\n")
        f.write(f">seq2_len{len(het1)}_cov20_read100_maxK50\n{het1}\n")
        f.write(f">seq3_len{len(het2)}_cov20_read100_maxK50\n{het2}\n")
    fwd, rev = simdata.paired_reads(rng, homo + het1, 100, 300, 30, 30.0)
    f2, r2 = simdata.paired_reads(rng, homo + het2, 100, 300, 30, 30.0)
    simdata.write_fasta(d / "f.fa", fwd + f2, prefix="f")
    simdata.write_fasta(d / "r.fa", rev + r2, prefix="r")
    return d


def test_iterate_one_round_byte_identical(frag, tmp_path, monkeypatch):
    """count -> kmer_divide -> solve_dbg -unphase -> polish -> gap_close
    -> final divide -> final polish, every intermediate file included."""
    wrote = run_both(frag, tmp_path, monkeypatch,
                     ["iterate", "-o", "it", "-c", "start_contig.fa", "-i",
                      "1", "-IP1", "r1.fa", "r2.fa"],
                     ["start_contig.fa", "r1.fa", "r2.fa"])
    inter = "it_iterateIntermediateResults/it1/"
    for name in ("it_kmerDivided.fa", "it_consensusScaffold.fa",
                 "it_polished_consensusScaffold.fa",
                 "it_gapClosed_polished_consensusScaffold.fa",
                 "it_final_divided.fa", "it_polished_final_divided.fa"):
        assert inter + name in wrote, name
    # the scaffolder joins the three contigs
    assert wrote[inter + "it_consensusScaffold.fa"].count(b">") == 1
    assert wrote["it_iterativeAssembly.fa"].count(b">") >= 1


def test_phase_byte_identical(diploid, tmp_path, monkeypatch):
    wrote = run_both(diploid, tmp_path, monkeypatch,
                     ["phase", "-o", "ph", "-i", "1", "-c", "c.fa", "-IP1",
                      "f.fa", "r.fa"], ["c.fa", "f.fa", "r.fa"])
    for name in ("ph_allPhaseBlock.fa", "ph_primaryBubble.fa",
                 "ph_secondaryBubble.fa", "ph_nonBubbleHetero.fa",
                 "ph_nonBubbleHomoCandidate.fa"):
        assert name in wrote, name
    assert len(wrote["ph_allPhaseBlock.fa"]) > 20000
