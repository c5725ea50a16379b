"""The port's graph and cleaning against models/dbg.py and models/clean.py.

Each case builds the JAX package's DBG from simulated reads and carries
the same node table into the port through platanus_b_tpu_torch.interop;
adjacency, unitig labels, sequences and every cleaning step must then
agree exactly (node ids are equal on both sides).
"""

import torch_threads  # noqa: F401  (first: sets torch's CPU threads)

import io

import numpy as np
import pytest

import simdata
from platanus_b_tpu.io.reads import pack_reads
from platanus_b_tpu.models import clean as jclean
from platanus_b_tpu.models.dbg import DBG as JDBG
from platanus_b_tpu.ops import count as jcnt
from platanus_b_tpu_torch import interop
from platanus_b_tpu_torch.models import clean as tclean
from platanus_b_tpu_torch.utils.log import LOG


def _dataset(name):
    rng = np.random.default_rng(len(name))
    if name == "errors":
        g = simdata.random_genome(rng, 700)
        return simdata.shotgun_reads(rng, g, 70, 30.0, error_rate=0.01), 21, 1
    if name == "circular":
        g = simdata.random_genome(rng, 260)
        reads = [(g + g)[i:i + 60] for i in range(0, len(g))]
        return reads, 21, 0
    if name == "repeat":
        unit = simdata.random_genome(rng, 60)
        g = "".join(simdata.random_genome(rng, 150) + unit for _ in range(3))
        return simdata.shotgun_reads(rng, g, 70, 30.0, error_rate=0.003), 21, 1
    if name == "haplotypes":
        g = simdata.random_genome(rng, 900)
        g2 = simdata.mutate(rng, g, 0.01)
        reads = (simdata.shotgun_reads(rng, g, 70, 20.0, error_rate=0.002)
                 + simdata.shotgun_reads(rng, g2, 70, 20.0, error_rate=0.002))
        return reads, 21, 1
    if name == "circular_tip":
        # a 1 kbp circle (its 1,001 k-mers keep the JAX graph at the
        # smallest capacity) and one read whose last base is wrong: a
        # one-k-mer error tip off a junction of the circle
        g = simdata.random_genome(rng, 1000)
        reads = [(g + g)[i:i + 60] for i in range(0, len(g), 2)]
        last = "ACGT"[("ACGT".index(g[159]) + 1) % 4]
        return reads + [g[100:159] + last], 21, 0
    raise KeyError(name)


def _pair(name):
    reads, k, cutoff = _dataset(name)
    batch = pack_reads(reads)
    keys, counts, n = jcnt.count_batch(batch.codes, k)
    keys_h, counts_h = jcnt.compact_host(keys, counts, n)
    keep = counts_h > cutoff
    j = JDBG(k, keys_h[keep], counts_h[keep])
    t = interop.dbg_from_arrays(k, keys_h[keep], counts_h[keep])
    return j, t


def _assert_same_graph(j, t):
    n = j.n
    assert t.n == n
    jsi, jso, jout, jod, jisj = (np.asarray(x) for x in j.topo)
    tsi, tso, tout, tod, tisj = (x.cpu().numpy() for x in t.topo)
    assert (tsi == jsi[:, :, :n]).all()
    live = jsi[:, :, :n] >= 0
    assert (tso[live] == jso[:, :, :n][live]).all()
    assert (tout == jout[:, :n]).all() and (tod == jod[:, :n]).all()
    assert (tisj == jisj[:n]).all()
    assert (t.alive.cpu().numpy() == np.asarray(j.alive)[:n]).all()
    ju, tu = j.label_unitigs(), t.label_unitigs()
    assert tu.num_unitigs == ju.num_unitigs
    lab = t.label_unitigs_device()
    assert (lab.uid.cpu().numpy() == ju.uid[:n]).all()
    member = ju.uid[:n] >= 0
    assert (lab.upos.cpu().numpy()[member] == ju.upos[:n][member]).all()
    assert (lab.uorient.cpu().numpy()[member] == ju.uorient[:n][member]).all()
    for f in ("ulen", "ucov", "uhead", "utail"):
        assert (getattr(tu, f) == getattr(ju, f)).all(), f
        assert getattr(tu, f).dtype == getattr(ju, f).dtype, f
    jf, joffs, jlens = j.unitig_sequences_flat()
    tf, toffs, tlens = t.unitig_sequences_flat()
    assert (tf == jf).all() and (toffs == joffs).all() and (tlens == jlens).all()
    # the JAX package's padded matrix, rebuilt from the port's flat form
    js, jl = j.unitig_sequences()
    ts = np.full_like(js, 4)
    for i, (o, ln) in enumerate(zip(toffs, tlens)):
        ts[i, :ln] = tf[o: o + ln]
    assert (ts == js).all() and (tlens == jl).all()
    ji, jc = j.junction_info()
    ti, tc = t.junction_info()
    assert (ti == ji).all() and (tc == jc).all()


DATASETS = ["errors", "circular", "repeat", "haplotypes"]


@pytest.mark.parametrize("name", DATASETS)
def test_adjacency_labels_sequences(name):
    j, t = _pair(name)
    _assert_same_graph(j, t)
    if name == "circular":
        # a cycle with no junction: the mirror-consistent cut gives one
        # unitig holding every k-mer
        u = t.label_unitigs()
        assert not t.topo[4].any()
        assert u.num_unitigs == 1 and u.ulen[0] == 260


def _loop_beside_pair():
    """A junction U with a unitig that leaves it and comes back (U + Q +
    U) and, beside it, two branches from U to a second junction (one base
    apart, c1 and c2, before a shared M): the loop's two ends attach to
    one junction, and only the pair is a bubble."""
    rng = np.random.default_rng(5)
    k = 21
    lead, u, q, m = (simdata.random_genome(rng, n) for n in (30, k, 30, 40))
    reads = 3 * [lead + u + q + u + "A" + m, u + "C" + m]
    keys, counts, n = jcnt.count_batch(pack_reads(reads).codes, k)
    keys_h, counts_h = jcnt.compact_host(keys, counts, n)
    return (JDBG(k, keys_h, counts_h),
            interop.dbg_from_arrays(k, keys_h, counts_h))


@pytest.mark.parametrize("name", DATASETS + ["loop_beside_pair"])
def test_bubble_mask_is_the_reference_mask(name):
    """The bubble mask of average_coverage_excluding_bubble, grouped on the
    device by unordered junction pair, marks the unitigs that the JAX
    package's dict of ordered pairs marks; a unitig from a junction back
    to itself is one member of its group, as the dict's set() makes it."""
    j, t = _loop_beside_pair() if name == "loop_beside_pair" else _pair(name)
    want = jclean._bubble_unitig_mask(j, j.label_unitigs())
    got = tclean._bubble_unitig_mask(t)
    assert got.cpu().numpy().tolist() == want.tolist()
    if name == "loop_beside_pair":
        head_j, _hq, tail_j, _tq = tclean._end_attachments(t)
        assert ((head_j == tail_j) & (head_j >= 0)).sum() == 1
        assert want.sum() == 2


@pytest.mark.parametrize("name", DATASETS)
def test_cut_branch_iterative(name):
    j, t = _pair(name)
    assert tclean.cut_branch_iterative(t, 0.5) == jclean.cut_branch_iterative(j, 0.5)
    _assert_same_graph(j, t)
    # one device round on the cleaned graph
    assert tclean.cut_branch(t, 0.5) == jclean.cut_branch(j, 0.5)
    _assert_same_graph(j, t)


def test_cut_branch_cuts_an_element_cycle(monkeypatch):
    """Once the error tip dies, its junction and the rest of the circle
    form one junction-free cycle of elements: the replay's ranking cuts it
    (the `  host replay` record counts the cut), and the totals and the
    graph equal the JAX package's."""
    j, t = _pair("circular_tip")
    assert t.topo[4].sum() == 1
    monkeypatch.setattr(LOG, "out", io.StringIO())
    monkeypatch.setattr(LOG, "spans", [])
    assert tclean.cut_branch_iterative(t, 0.5) \
        == jclean.cut_branch_iterative(j, 0.5) == 1
    _assert_same_graph(j, t)
    assert not t.topo[4].any() and t.label_unitigs().num_unitigs == 1
    replay, = [s.counters for s in LOG.spans if s.name == "  host replay"]
    # round 1 kills the tip, round 2 ranks the cycle and kills nothing
    assert replay["rounds"] == 2 and replay["cycle_cuts"] == 1
    assert replay["reads"] == 1 + 2 * replay["rounds"]


@pytest.mark.parametrize("name", DATASETS)
def test_delete_erroneous_iterative(name):
    j, t = _pair(name)
    cov_j = jclean.average_coverage_excluding_bubble(j)
    cov_t = tclean.average_coverage_excluding_bubble(t)
    assert cov_t == cov_j
    args = (2 * j.k, 0.5 * cov_j + 0.5, 0.5)
    assert (tclean.delete_erroneous_iterative(t, *args)
            == jclean.delete_erroneous_iterative(j, *args))
    _assert_same_graph(j, t)
    assert tclean.delete_erroneous(t, 40, 8.0) == jclean.delete_erroneous(j, 40, 8.0)
    _assert_same_graph(j, t)


@pytest.mark.parametrize("name", ["haplotypes", "repeat"])
def test_crush_bubble_iterative(name):
    j, t = _pair(name)
    jclean.cut_branch_iterative(j, 0.5)
    tclean.cut_branch_iterative(t, 0.5)
    cov = jclean.average_coverage_excluding_bubble(j)
    jb, tb = [], []
    nj = jclean.crush_bubble_iterative(j, cov, 0.1, jb)
    nt = tclean.crush_bubble_iterative(t, cov, 0.1, tb)
    assert nt == nj
    if name == "haplotypes":
        assert nj > 0
    assert [b.coverage for b in tb] == [b.coverage for b in jb]
    assert all((x.seq == y.seq).all() for x, y in zip(tb, jb))
    assert (t.counts.cpu().numpy() == np.asarray(j.counts)[: j.n]).all()
    _assert_same_graph(j, t)


@pytest.mark.parametrize("case", ["uncovered_middle", "errors_and_n"])
def test_divide_straight_node(case):
    """tests/test_dbg.py:166-199's inputs (a 600 bp unitig at k = 21, reads
    over [0, 250) and [350, 600)); then the same with substitutions and an
    N in some reads, which then map only partly or not at all. The same
    kill count and the same graph on both sides."""
    from platanus_b_tpu.models.assemble_core import \
        divide_straight_node as jdivide
    from platanus_b_tpu_torch.io.reads import pack_reads as tpack
    from platanus_b_tpu_torch.models.assemble_core import (
        divide_straight_node as tdivide, stage_reads)

    rng = np.random.default_rng(42)
    k = 21
    genome = simdata.random_genome(rng, 600)
    keys, counts, n = jcnt.count_batch(pack_reads([genome]).codes, k)
    keys_h, counts_h = jcnt.compact_host(keys, counts, n)
    j = JDBG(k, keys_h, counts_h)
    t = interop.dbg_from_arrays(k, keys_h, counts_h)
    assert j.label_unitigs().num_unitigs == 1
    reads = [genome[st: st + 60] for lo, hi in ((0, 250), (350, 600))
             for st in range(lo, hi - 60, 20)]
    if case == "errors_and_n":
        reads[3] = simdata.mutate(rng, reads[3], 0.05)
        reads[9] = reads[9][:30] + "N" + reads[9][31:]
        reads.append(simdata.random_genome(rng, 60))
    n_kill = jdivide(j, [pack_reads(reads)])
    assert tdivide(t, stage_reads([tpack(reads)], "cpu")) == n_kill > 0
    _assert_same_graph(j, t)
    # the uncovered middle cuts the unitig in two; a read left out by its
    # errors uncovers more
    assert t.label_unitigs().num_unitigs == (2 if case == "uncovered_middle"
                                             else 3)
