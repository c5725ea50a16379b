"""The long-read path of the port against the JAX package: the chaining
DP's gap cost and the DP itself at gap sizes above zero, `align_batch` on
map-ont reads with indels through the card branch of segment
verification, and the CLI commands that take long reads (`solve_dbg -ont`,
`phase -ont`, `iterate -i 2 -ont`), every written file byte for byte
(run_both, tests/test_torch_solve_dbg.py).

Long reads come from simulate.simulate_long_reads: both strands, with
substitutions, insertions and deletions.
"""

import torch_threads  # noqa: F401  (first: sets torch's CPU threads)

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simdata
from platanus_b_tpu.io.fasta import seq_to_codes
from platanus_b_tpu.models import longread as jlongread
from platanus_b_tpu_torch.models import longread as tlongread
from platanus_b_tpu_torch.ops.gapcost import chain_gap_cost
from platanus_b_tpu_torch.simulate import simulate_long_reads
from test_torch_solve_dbg import run_both
from torch_smoke_expected import jax_card_branch, port_card_branch

# ONT-like: 2 % errors, half of them substitutions
LR_ERRORS = {"sub": 0.01, "ins": 0.005, "dele": 0.005}


@pytest.mark.parametrize("max_gap", [5000, 10000])
def test_chain_gap_cost_matches_xla(max_gap):
    """Every entry of the table equals XLA's float32 value of the
    reference's expression (platanus_b_tpu/models/longread.py:51-52)."""
    g = np.arange(max_gap + 1, dtype=np.float32)
    want = np.asarray(jax.jit(
        lambda g: g * 0.1 + jnp.where(g > 0, jnp.log2(g + 1.0) * 0.5, 0.0))(g))
    got = chain_gap_cost(max_gap)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def _anchor_groups(rng, B, cap):
    """B anchor groups sorted by (t, q) like _collect_groups' output, with
    query and target steps that differ by indel-sized amounts and, now and
    then, by thousands of bases; rows past n are padding."""
    qs = np.zeros((B, cap), np.int32)
    ts = np.zeros((B, cap), np.int32)
    ns = np.zeros(B, np.int32)
    for b in range(B):
        n = int(rng.integers(cap // 2 + 1, cap + 1))
        dq = rng.integers(1, 60, size=n)
        dt = dq + rng.integers(-8, 9, size=n) * (rng.random(n) < 0.5)
        jump = rng.random(n) < 0.05
        dt[jump] += rng.integers(-3000, 3000, size=int(jump.sum()))
        q = np.cumsum(dq)
        t = np.cumsum(np.maximum(dt, 0)) + 100
        order = np.lexsort((q, t))
        qs[b, :n], ts[b, :n], ns[b] = q[order], t[order], n
    return qs, ts, ns


@pytest.mark.parametrize("cap,max_gap,kk", [(64, 5000, 15), (128, 5000, 15),
                                            (256, 10000, 19)])
def test_chain_kernel_matches_reference(cap, max_gap, kk):
    """f and prev bitwise equal to the reference's vmapped fori_loop on
    groups whose links have gap sizes g > 0."""
    qs, ts, ns = _anchor_groups(np.random.default_rng(cap), 48, cap)
    jf, jp = jlongread._chain_kernel(cap, 25, max_gap, kk)(
        jnp.asarray(qs), jnp.asarray(ts), jnp.asarray(ns))
    tf, tp = tlongread._chain_kernel(cap, 25, max_gap, kk)(
        torch.from_numpy(qs), torch.from_numpy(ts), torch.from_numpy(ns))
    jf, jp, tf, tp = np.asarray(jf), np.asarray(jp), tf.numpy(), tp.numpy()
    assert np.array_equal(tf.view(np.uint32), jf.view(np.uint32))
    assert np.array_equal(tp, jp)
    # links exist, and many of them bridge a gap g > 0
    linked = np.flatnonzero((tp >= 0).ravel())
    rows, cols = np.divmod(linked, cap)
    prev = tp.ravel()[linked]
    g = np.abs((qs[rows, cols] - qs[rows, prev]) - (ts[rows, cols]
                                                   - ts[rows, prev]))
    assert (g > 0).sum() > 100


def _reads_with_indels(tmp_path, genome, coverage, mean_len, seed):
    path = tmp_path / f"lr{seed}.fa"
    simulate_long_reads(str(path), genome, coverage, mean_len, seed=seed,
                        **LR_ERRORS)
    names, codes = [], []
    for line in path.read_text().splitlines():
        if line.startswith(">"):
            names.append(line[1:])
        else:
            codes.append(seq_to_codes(line))
    return names, codes


@pytest.mark.parametrize("branch", ["card", "cpu"])
def test_align_batch_map_ont_with_indels(tmp_path, monkeypatch, branch):
    """map-ont reads with indels onto three contigs, one of them reverse
    complemented: the same PAF lines from both packages, on the card
    branch of segment verification (K1's plain version at band 128
    against the Pallas kernel in interpret mode, each forced as
    tests/torch_smoke_expected.py forces it) and on the CPU branch (the
    host DP at band 64 in both)."""
    monkeypatch.setenv("PLATANUS_B_TPU_TORCH_DEVICE", "cpu")
    rng = np.random.default_rng(11)
    genome = simdata.random_genome(rng, 9000)
    contigs = [genome[:3000], simdata.rc(genome[3100:6000]), genome[6100:]]
    tnames = [f"c{i}" for i in range(3)]
    tcodes = [seq_to_codes(c) for c in contigs]
    names, reads = _reads_with_indels(tmp_path, genome, 2.0, 2500, 5)
    jseg, tseg = [], []
    forced = ((jax_card_branch(jseg), port_card_branch(tseg))
              if branch == "card"
              else (contextlib.nullcontext(), contextlib.nullcontext()))
    with forced[0]:
        want = jlongread.LongReadAligner(tcodes, tnames,
                                         "map-ont").align_batch(reads, names)
    with forced[1]:
        got = tlongread.LongReadAligner(tcodes, tnames,
                                        "map-ont").align_batch(reads, names)
    assert [a.paf_line() for a in got] == [a.paf_line() for a in want]
    # the card branch ran K1 (Pallas / plain) once over the same segments
    assert tseg == jseg == ([jseg[0]] if branch == "card" else [])
    assert len(want) >= len(reads)
    assert any(a.strand == "-" for a in want)
    assert any(a.matches < a.block_len for a in want)


@pytest.fixture(scope="module")
def lr_contigs(tmp_path_factory):
    """tests/test_combinatorial.py:44-65's genome and contigs (24 kbp in
    three contigs, 1 kbp dropped between them), with long reads that carry
    indels at the same coverage and mean length."""
    d = tmp_path_factory.mktemp("lr_contigs")
    rng = np.random.default_rng(42)
    genome = simdata.random_genome(rng, 24000)
    contigs = [genome[:7500], genome[8500:15500], genome[16500:]]
    with open(d / "c.fa", "w") as f:
        for i, c in enumerate(contigs):
            f.write(f">seq{i+1}_len{len(c)}_cov40_read100_maxK50\n{c}\n")
    simulate_long_reads(str(d / "lr.fa"), genome, 15.0, 6000, seed=7,
                        **LR_ERRORS)
    return d


def test_solve_dbg_long_reads_byte_identical(lr_contigs, tmp_path,
                                             monkeypatch):
    """`solve_dbg -unphase -reduce_redundancy -ont` with no PE library:
    the long-read links alone join the three contigs."""
    wrote = run_both(lr_contigs, tmp_path, monkeypatch,
                     ["solve_dbg", "-unphase", "-reduce_redundancy", "-o",
                      "out", "-c", "c.fa", "-ont", "lr.fa"],
                     ["c.fa", "lr.fa"])
    scaffolds = wrote["out_consensusScaffold.fa"].split(b">")[1:]
    assert max(len(s) for s in scaffolds) > 20000


@pytest.fixture(scope="module")
def diploid_lr(tmp_path_factory):
    """tests/test_torch_iterate.py's `diploid` data (a 16 kbp homozygous
    contig and two 8 kbp haplotigs 0.4 % apart, 30x innie pairs from each
    haplotype) plus long reads with indels from each haplotype."""
    d = tmp_path_factory.mktemp("diploid_lr")
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
    with open(d / "lr.fa", "w") as out:
        for i, hap in enumerate((homo + het1, homo + het2)):
            simulate_long_reads(str(d / "h.fa"), hap, 3.0, 4000, seed=20 + i,
                                **LR_ERRORS)
            out.write((d / "h.fa").read_text().replace(">ont", f">h{i}_"))
    (d / "h.fa").unlink()
    return d


def test_phase_long_reads_byte_identical(diploid_lr, tmp_path, monkeypatch):
    wrote = run_both(diploid_lr, tmp_path, monkeypatch,
                     ["phase", "-o", "ph", "-i", "1", "-c", "c.fa", "-IP1",
                      "f.fa", "r.fa", "-ont", "lr.fa"],
                     ["c.fa", "f.fa", "r.fa", "lr.fa"])
    for name in ("ph_allPhaseBlock.fa", "ph_primaryBubble.fa",
                 "ph_secondaryBubble.fa"):
        assert name in wrote, name


def test_iterate_two_rounds_long_reads_byte_identical(tmp_path, monkeypatch):
    """tests/test_iterate.py:42-58's data (6 kbp in two contigs, 40x innie
    pairs) with long reads that carry indels: `iterate -i 2 -ont` runs
    both rounds with -ont, merge and -extend in round 2, the final divide
    with -ont and one combine round; every file, intermediates included."""
    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.default_rng(42)
    genome = simdata.random_genome(rng, 6000)
    contigs = [genome[0:2800], genome[3000:6000]]
    with open(src / "start_contig.fa", "w") as f:
        for i, c in enumerate(contigs):
            f.write(f">seq{i+1}_len{len(c)}_cov40_read100_maxK32\n{c}\n")
    fwd, rev = simdata.paired_reads(rng, genome, read_len=100, insert=500,
                                    sd=50, coverage=40.0, error_rate=0.002)
    simdata.write_fasta(src / "r1.fa", fwd)
    simdata.write_fasta(src / "r2.fa", rev)
    simulate_long_reads(str(src / "lr.fa"), genome, 6.0, 3000, seed=9,
                        **LR_ERRORS)
    wrote = run_both(src, tmp_path, monkeypatch,
                     ["iterate", "-o", "it", "-c", "start_contig.fa", "-i",
                      "2", "-IP1", "r1.fa", "r2.fa", "-ont", "lr.fa"],
                     ["start_contig.fa", "r1.fa", "r2.fa", "lr.fa"])
    inter = "it_iterateIntermediateResults/"
    for name in ("it2/it_merged.fa", "it2/it_consensusScaffold.fa",
                 "it2/it_polished_final_divided.fa", "it2/it1_combined.fa",
                 "it2/it1_closed.fa", "it2/it1_closed.fa.rmred"):
        assert inter + name in wrote, name
    assert wrote["it_iterativeAssembly.fa"].count(b">") >= 1
