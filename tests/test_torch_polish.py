"""`polish` in the port against the JAX package: the model on the cases of
tests/test_polish.py, and the CLI byte for byte.

The port runs its plain PyTorch versions on the CPU; outputs are exact.
"""

import torch_threads  # noqa: F401  (first: sets torch's CPU threads)

import os

import numpy as np
import pytest

import simdata
from platanus_b_tpu.commands.main import main as jax_main
from platanus_b_tpu.io.fasta import seq_to_codes
from platanus_b_tpu.io.reads import pack_reads
from platanus_b_tpu.models import polish as jpolish
from platanus_b_tpu.models.seqlib import PairLibrary as JPairLibrary
from platanus_b_tpu_torch.commands.main import main as port_main
from platanus_b_tpu_torch.models import polish as tpolish
from platanus_b_tpu_torch.models.seqlib import PairLibrary as TPairLibrary


def _libs(rng, genome, coverage=30.0, err=0.0):
    fwd, rev = simdata.paired_reads(rng, genome, read_len=100, insert=400,
                                    sd=30, coverage=coverage, error_rate=err)
    fb, rb = pack_reads(fwd), pack_reads(rev)
    return (JPairLibrary(fb.codes, fb.lengths, rb.codes, rb.lengths),
            TPairLibrary(fb.codes, fb.lengths, rb.codes, rb.lengths))


def _case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "clean":                     # test_polish.py:20
        genome = simdata.random_genome(rng, 4000)
        return [seq_to_codes(genome)], _libs(rng, genome), {}
    if name == "chimera":                   # test_polish.py:29
        ga = simdata.random_genome(rng, 4000)
        junk = simdata.random_genome(rng, 500)
        chimera = ga[:2000] + junk + ga[2000:]
        return ([seq_to_codes(chimera)], _libs(rng, ga, coverage=40.0),
                {"min_contig_length": 100})
    if name == "multi_contig":              # test_polish.py:57
        contigs = [rng.integers(0, 4, size=n, dtype=np.uint8)
                   for n in (150, 130, 6000)]
        g = "".join("ACGT"[b] for b in contigs[2])
        return contigs, _libs(rng, g, coverage=20.0, err=0.01), {}
    # errors, a low-identity region and several contigs at -e 0.99
    g = simdata.random_genome(rng, 6000)
    bad = simdata.mutate(rng, g[3000:3400], 0.06)
    contigs = [seq_to_codes(g[:2500]), seq_to_codes(g[2500:3000] + bad
                                                    + g[3400:])]
    return (contigs, _libs(rng, g, coverage=25.0, err=0.01),
            {"min_identity": 0.99, "min_odd_ratio": 0.5})


@pytest.mark.parametrize("name", ["clean", "chimera", "multi_contig",
                                  "errors_and_ratio"])
def test_polish_matches_jax(name):
    contigs, (jlib, tlib), opts = _case(name)
    jout, jkept = jpolish.polish(contigs, [jlib], jpolish.PolishOptions(**opts),
                                 contig_max_k=32)
    tout, tkept = tpolish.polish(contigs, [tlib], tpolish.PolishOptions(**opts),
                                 contig_max_k=32)
    assert (tkept == jkept).all()
    assert len(tout) == len(jout)
    for a, b in zip(tout, jout):
        assert a.dtype == b.dtype and (a == b).all()
    assert (tlib.average_insert, tlib.sd_insert) == \
        (jlib.average_insert, jlib.sd_insert)
    if name == "clean":
        assert (tout[0] == contigs[0]).all()


def test_mask_helpers_match_jax():
    seq = np.array([0, 1, 4, 2, 3, 1, 4, 0], dtype=np.uint8)
    assert (tpolish.mask_short_runs(seq, 3)
            == jpolish.mask_short_runs(seq, 3)).all()
    for s in (np.array([4, 4, 1, 2, 4, 3, 4], np.uint8), np.array([4, 4], np.uint8)):
        assert (tpolish.trim_edge_n(s) == jpolish.trim_edge_n(s)).all()


@pytest.mark.parametrize("flags", [[], ["-e", "0.99", "-r", "0.5", "-l", "120"]])
def test_polish_cli_byte_identical(tmp_path, monkeypatch, flags):
    """Two contig files, relative paths from the work directory (the
    output name is built from the input path, polish_cmd.py:31-39)."""
    rng = np.random.default_rng(17)
    genome = simdata.random_genome(rng, 5000)
    fwd, rev = simdata.paired_reads(rng, genome, 100, 400, 30, 30.0,
                                    error_rate=0.01)
    simdata.write_fasta(tmp_path / "r1.fa", fwd)
    simdata.write_fasta(tmp_path / "r2.fa", rev)
    junk = simdata.random_genome(rng, 300)
    (tmp_path / "a_contig.fa").write_text(
        f">seq1_len2700_cov30_read100_maxK50\n{genome[:2400] + junk}\n"
        f">seq2_len80_cov12_read100_maxK50\n{genome[2400:2480]}\n")
    (tmp_path / "b.fa").write_text(
        f">scaffold7_len2520_cov31_read100_maxK50\n{genome[2480:]}\n")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PLATANUS_B_TPU_TORCH_DEVICE", "cpu")
    base = ["polish", "-c", "a_contig.fa", "b.fa", "-IP1", "r1.fa", "r2.fa"]
    assert jax_main(base + flags + ["-o", "jax"]) == 0
    assert port_main(base + flags + ["-o", "port"]) == 0
    outs = sorted(p for p in os.listdir(tmp_path) if p.startswith("jax_"))
    assert outs == ["jax_polished_a_contig.fa", "jax_polished_b.fa"]
    for name in outs:
        want = (tmp_path / name).read_bytes()
        got = (tmp_path / ("port" + name[3:])).read_bytes()
        assert len(want) > 0 and got == want, name


def test_polish_cli_errors(tmp_path, monkeypatch):
    monkeypatch.setenv("PLATANUS_B_TPU_TORCH_DEVICE", "cpu")
    assert port_main(["polish", "-o", str(tmp_path / "x")]) == 5
    assert port_main(["polish", "-c", str(tmp_path / "none.fa"),
                      "-IP1", "a", "b"]) == 2
