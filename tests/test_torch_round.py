"""The short-read stages of an `iterate` round in the port — `gap_close`,
`kmer_divide` and `merge` (iterate_cmd.py:88-149) — against the JAX
package, byte for byte, on a small gap-closing dataset shaped like
parity/gapclose_bench.py's. Both CLIs run from the work directory with
relative paths, so output names carry no directory.
"""

import torch_threads  # noqa: F401  (first: sets torch's CPU threads)

import os

import numpy as np
import pytest

import simdata
from platanus_b_tpu.commands.main import main as jax_main
from platanus_b_tpu.ops import count as jcnt
from platanus_b_tpu_torch.commands.main import main as port_main
from platanus_b_tpu_torch.ops import count as tcnt


def _fasta(path, records):
    with open(path, "w") as f:
        for name, seq in records:
            f.write(f">{name}\n")
            for i in range(0, len(seq), 80):
                f.write(seq[i: i + 80] + "\n")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A 6 kbp genome; a scaffold with 4 gaps of 100 Ns every 1,200 bp, a
    copy of one of its pieces (redundant) and a chimeric contig; 30x innie
    pairs; k-mer occurrence tables at k 32 and 62 from the port's
    `assemble -kmer_occ_only` (its bytes equal the JAX package's,
    tests/test_torch_assemble.py)."""
    d = tmp_path_factory.mktemp("round")
    rng = np.random.default_rng(42)
    genome = simdata.random_genome(rng, 6000)
    scaf = list(genome)
    for g in range(4):
        mid = (g + 1) * 1200 - 50
        scaf[mid: mid + 100] = "N" * 100
    scaf = "".join(scaf)
    junk = simdata.random_genome(rng, 400)
    _fasta(d / "scaffold.fa", [
        (f"scaf1_len{len(scaf)}_cov40_read100_maxK62", scaf),
        ("scaf2_len500_cov35_read100_maxK62", genome[200:700]),
        ("scaf3_len1300_cov20_read100_maxK62", genome[4000:4500] + junk
         + simdata.rc(genome[1300:1700]))])
    fwd, rev = simdata.paired_reads(rng, genome, 100, 400, 40, 30.0,
                                    error_rate=0.002)
    simdata.write_fasta(d / "r1.fa", fwd)
    simdata.write_fasta(d / "r2.fa", rev)
    cwd = os.getcwd()
    os.chdir(d)
    os.environ["PLATANUS_B_TPU_TORCH_DEVICE"] = "cpu"
    try:
        for k in (32, 62):
            assert port_main(["assemble", "-kmer_occ_only", "-n", "1", "-k",
                              str(k), "-f", "r1.fa", "r2.fa", "-o",
                              f"occ{k}"]) == 0
    finally:
        os.chdir(cwd)
        del os.environ["PLATANUS_B_TPU_TORCH_DEVICE"]
    return d


def _both(data, monkeypatch, argv, tag):
    """Run argv (with -o added) through both CLIs from `data`; return the
    names of the files the JAX run wrote, as pairs (jax name, port name)."""
    monkeypatch.chdir(data)
    monkeypatch.setenv("PLATANUS_B_TPU_TORCH_DEVICE", "cpu")
    before = set(os.listdir(data))
    assert jax_main(argv + ["-o", f"jax{tag}"]) == 0
    written = sorted(set(os.listdir(data)) - before)
    assert port_main(argv + ["-o", f"port{tag}"]) == 0
    pairs = [(n, n.replace(f"jax{tag}", f"port{tag}")) for n in written]
    for jname, pname in pairs:
        want = (data / jname).read_bytes()
        got = (data / pname).read_bytes()
        assert got == want, jname
    return pairs


@pytest.mark.parametrize("k", [32, 62])
@pytest.mark.parametrize("flags", [[], ["-mask"], ["-recalc_cov"]])
def test_kmer_divide_cli_byte_identical(data, monkeypatch, k, flags):
    tag = f"kd{k}{''.join(flags)}"
    pairs = _both(data, monkeypatch, ["kmer_divide", "-k", f"occ{k}_kmer_occ.bin",
                                      "-f", "scaffold.fa"] + flags, tag)
    assert len(pairs) == 1 and (data / pairs[0][0]).stat().st_size > 0


@pytest.mark.parametrize("flags", [[], ["-reduce_redundancy"], ["-extend"],
                                   ["-eo", "2"]])
def test_gap_close_cli_byte_identical(data, monkeypatch, flags):
    tag = f"gc{''.join(flags)}"
    pairs = _both(data, monkeypatch, ["gap_close", "-c", "scaffold.fa",
                                      "-IP1", "r1.fa", "r2.fa"] + flags, tag)
    names = sorted(j for j, _p in pairs)
    assert names == [f"jax{tag}_extraContig.fa", f"jax{tag}_gapClosed_scaffold.fa"]
    closed = (data / f"jax{tag}_gapClosed_scaffold.fa").read_text()
    n_records = closed.count(">")
    assert n_records == (2 if flags == ["-reduce_redundancy"] else 3)


@pytest.mark.parametrize("flags", [["-k", "1.0", "-l", "1.0"],
                                   ["-k", "0.5", "-l", "1.0", "-u", "0.1"]])
def test_merge_cli_byte_identical(data, monkeypatch, flags):
    """The round's merge of the gap-closed scaffolds and the extra contigs;
    then, at k 50 with bubble crushing, two haplotype contig sets."""
    monkeypatch.chdir(data)
    if "-u" in flags:
        rng = np.random.default_rng(3)
        g = simdata.random_genome(rng, 3000)
        g2 = simdata.mutate(rng, g, 0.01)
        _fasta(data / "hap.fa", [("seq1_len3000_cov20_read100_maxK62", g),
                                 ("seq2_len3000_cov18_read100_maxK62", g2)])
        inputs = ["hap.fa"]
    else:
        monkeypatch.setenv("PLATANUS_B_TPU_TORCH_DEVICE", "cpu")
        assert port_main(["gap_close", "-reduce_redundancy", "-c",
                          "scaffold.fa", "-IP1", "r1.fa", "r2.fa", "-o",
                          "mg"]) == 0
        inputs = ["mg_gapClosed_scaffold.fa", "mg_extraContig.fa"]
    tag = "mg" + ("u" if "-u" in flags else "")
    pairs = _both(data, monkeypatch, ["merge", "-f"] + inputs + flags, tag)
    names = sorted(j for j, _p in pairs)
    assert names == [f"jax{tag}_merged.fa", f"jax{tag}_mergedJunctionKmer.fa"]
    assert (data / names[0]).stat().st_size > 0


@pytest.mark.parametrize("k", [32, 62])
def test_read_occurrence_table_binary_matches_jax(data, k):
    path = str(data / f"occ{k}_kmer_occ.bin")
    jk, jkeys, jcounts = jcnt.read_occurrence_table_binary(path)
    tk, tkeys, tcounts = tcnt.read_occurrence_table_binary(path)
    assert tk == jk == k
    assert tkeys.dtype == jkeys.dtype and (tkeys == jkeys).all()
    assert tcounts.dtype == jcounts.dtype and (tcounts == jcounts).all()
    assert len(tkeys) > 1000
