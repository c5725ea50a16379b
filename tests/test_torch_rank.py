"""The labeling's list ranking and the bulk key search of the port
(ops/rank.py, models/dbg.py:_label_core, ops/search.py) against the JAX
package, exactly.

- doubling_rank_plain against models/dbg.py:_doubling_rank on seeded
  forests of chains, trees and cycles, with an `iters` cap that binds and
  one that does not, all-dead input and one long cycle, and the wrapper
  rank_from_prev from the same links;
- the port's _label_core against the JAX package's on graphs with
  junction-free cycles (which run cycle_min_pair_plain), at the default
  cap and at one that binds;
- the per-unitig float32 count sums (unitig_count_sums, the labeling's
  ucov and _chain_pull's csum) against _label_core and
  clean._chain_pull_kernel where they pass 2^24: one 400-node unitig, two
  interleaved unitigs, and a graph below 2^24 where the exact int64 sum
  agrees; the plain version against a float32 loop on random unitigs;
- lookup, contains and lookup_range against _lookup_jit and
  lookup_range_jit at 1-4 lanes (1-8 words), with no live row, a full
  table, duplicate runs, queries above the last row and queries equal to
  the SENTINEL.

On the CPU the wrappers take the plain versions and never build the
kernels (list_rank, lex_search and unitig_sum run only on the card,
tests/test_torch_cuda.py).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simdata
from platanus_b_tpu.io.reads import pack_reads
from platanus_b_tpu.models import clean as jclean
from platanus_b_tpu.models import dbg as jdbg
from platanus_b_tpu.ops import count as jcnt
from platanus_b_tpu.ops import search as jsearch
from platanus_b_tpu_torch import interop, kernels
from platanus_b_tpu_torch.models import clean as tclean
from platanus_b_tpu_torch.models import dbg as tdbg
from platanus_b_tpu_torch.ops import keys as tkeys
from platanus_b_tpu_torch.ops import rank as trank
from platanus_b_tpu_torch.ops import search as tsearch
from platanus_b_tpu_torch.simulate import (coverage_counts, label_links,
                                           search_inputs)


def _default_iters(m: int) -> int:
    cap = tdbg._next_pow2(m // 2)
    return max(1, math.ceil(math.log2(max(cap, 2))) + 1)


def _prv(nxt: np.ndarray) -> np.ndarray:
    nt = nxt[np.arange(len(nxt)) ^ 1]
    return np.where(nt >= 0, nt ^ 1, -1)


def _forest(case: str) -> tuple[np.ndarray, int]:
    """(ptr, iters) of each case."""
    if case == "chains":
        ptr = _prv(label_links(11, 700))
    elif case == "chains_capped":
        return _prv(label_links(12, 700, mean_chain=200)), 3
    elif case == "cycles":
        ptr = _prv(label_links(13, 600, cycle_share=0.3))
    elif case == "one_long_cycle":
        ptr = _prv(label_links(14, 512, cycle_share=1.0))
    elif case == "trees":
        rng = np.random.default_rng(15)
        m = 900
        perm = rng.permutation(m)
        parent = np.where(rng.random(m) < 0.9,
                          rng.integers(0, np.maximum(np.arange(m), 1)), -1)
        parent[0] = -1
        ptr = np.full(m, -1, np.int64)
        ptr[perm] = np.where(parent >= 0, perm[np.maximum(parent, 0)], -1)
    elif case == "trees_capped":
        ptr, _ = _forest("trees")
        return ptr, 2
    elif case == "all_dead":
        ptr = np.full(256, -1, np.int64)
    elif case == "single_id":
        ptr = np.array([-1], np.int64)
    else:
        raise KeyError(case)
    return ptr, _default_iters(len(ptr))


def _numpy_steps(ptr: np.ndarray, iters: int) -> int:
    """Steps the reference's while_loop takes: until no pointer is live."""
    m = len(ptr)
    for step in range(iters):
        if not (ptr >= 0).any():
            return step
        ptr = np.where(ptr >= 0, ptr[np.clip(ptr, 0, m - 1)], ptr)
    return iters


FORESTS = ["chains", "chains_capped", "cycles", "one_long_cycle", "trees",
           "trees_capped", "all_dead", "single_id"]


@pytest.mark.parametrize("case", FORESTS)
def test_doubling_rank_plain_matches_reference(case):
    ptr, iters = _forest(case)
    m = len(ptr)
    rank0 = np.where(ptr >= 0, 1, 0)
    anchor0 = np.where(ptr >= 0, ptr, np.arange(m))
    jp, jr, ja = jdbg._doubling_rank(
        jnp.asarray(ptr, jnp.int32), jnp.asarray(rank0, jnp.int32),
        jnp.asarray(anchor0, jnp.int32), iters)
    args = [torch.from_numpy(x.astype(np.int64)) for x in (ptr, rank0,
                                                            anchor0)]
    tp, tr, ta, steps = trank.doubling_rank_plain(*args, iters)
    for got, want in ((tp, jp), (tr, jr), (ta, ja)):
        assert (got.numpy() == np.asarray(want)).all()
    assert steps == _numpy_steps(ptr, iters)
    # the dispatching wrapper on CPU tensors, from the links alone: the
    # same, with its stats
    wp, wr, wa, stats = trank.rank_from_prev(args[0], iters)
    assert torch.equal(wp, tp) and torch.equal(wr, tr) and torch.equal(wa, ta)
    assert stats.tolist() == [steps, int((tp >= 0).any())]
    if case in ("cycles", "one_long_cycle", "chains_capped"):
        assert stats[1] == 1 and steps == iters
    if case == "all_dead":
        assert stats.tolist() == [0, 0]


def _graph(name):
    """(JAX DBG, port DBG) over the same node table, each graph holding
    junction-free cycles."""
    rng = np.random.default_rng(len(name) + 100)
    if name == "circular":            # tests/test_torch_dbg.py's dataset
        rng = np.random.default_rng(len(name))
        g = simdata.random_genome(rng, 260)
        reads, k = [(g + g)[i:i + 60] for i in range(len(g))], 21
    elif name == "two_circles_and_a_line":
        reads, k = [], 21
        for size, circular in ((300, True), (520, True), (400, False)):
            g = simdata.random_genome(rng, size)
            src = g + g[:59] if circular else g
            reads += [src[i:i + 60] for i in range(len(src) - 59)]
    elif name == "circle_k33":
        g = simdata.random_genome(rng, 700)
        reads, k = [(g + g)[i:i + 80] for i in range(len(g))], 33
    else:
        raise KeyError(name)
    keys, counts, n = jcnt.count_batch(pack_reads(reads).codes, k)
    keys_h, counts_h = jcnt.compact_host(keys, counts, n)
    return (jdbg.DBG(k, keys_h, counts_h),
            interop.dbg_from_arrays(k, keys_h, counts_h))


@pytest.mark.parametrize("iters", [None, 3], ids=["default_cap", "cap3"])
@pytest.mark.parametrize("name", ["circular", "two_circles_and_a_line",
                                  "circle_k33"])
def test_label_core_with_cycles_matches_reference(name, iters, monkeypatch):
    cuts = []

    def counted(*args):
        cuts.append(args[0].shape[0])
        return trank.cycle_min_pair(*args)

    monkeypatch.setattr(tdbg, "cycle_min_pair", counted)
    j, t = _graph(name)
    n = t.n
    if iters is None:
        iters = max(1, math.ceil(math.log2(max(j.capacity, 2))) + 1)
    si, so, _out, od, isj = j.topo
    want = jdbg._label_kernel(si, so, od, isj, j.alive, j.counts,
                              iters=iters)
    juid, jupos, juor, jnum, julen, jucov, jhead, jtail = (
        np.asarray(x) for x in want)
    tsi, tso, _tout, tod, tisj = t.topo
    lab = tdbg._label_core(tsi, tso, tod, tisj, t.alive, t.counts, iters)
    # a junction-free cycle is present, so the cut ran once
    assert cuts == [2 * n]
    num_u = int(jnum)
    assert lab.num_u == num_u
    assert (lab.uid.numpy() == juid[:n]).all()
    member = juid[:n] >= 0
    assert (lab.upos.numpy()[member] == jupos[:n][member]).all()
    assert (lab.uorient.numpy()[member] == juor[:n][member]).all()
    for got, ref in ((lab.ulen, julen), (lab.ucov, jucov),
                     (lab.uhead, jhead), (lab.utail, jtail)):
        assert (got.numpy() == ref[:num_u]).all()
    if iters > 3 and name != "two_circles_and_a_line":
        # one circle: a single unitig holds every k-mer
        assert num_u == 1 and int(lab.ulen[0]) == n


def test_cycle_min_pair_plain_steps():
    """Each step carries the smallest (a, b) pair one doubling further
    along the pointers; a dead pointer keeps its pair."""
    ptr = torch.tensor([3, 0, 1, 2, -1])
    a = torch.tensor([5, 2, 7, 2, 0])
    b = torch.tensor([1, 9, 0, 4, 0])
    a1, b1 = trank.cycle_min_pair_plain(ptr, a, b, 1)
    assert a1.tolist() == [2, 2, 2, 2, 0] and b1.tolist() == [4, 9, 9, 4, 0]
    a2, b2 = trank.cycle_min_pair(ptr, a, b, 2)
    assert a2.tolist() == [2, 2, 2, 2, 0] and b2.tolist() == [4, 4, 4, 4, 0]


EXACT = 1 << 24


def _sum_graph(case):
    """(k, keys, counts) of a node table whose unitigs' count sums pass
    2^24 (or, "below", do not). "one_unitig": a random 430 bp genome at
    k 31, one unitig of 400 nodes with counts of 50,000-65,534 summing to
    23,040,995 (exact mean 57602.49; the reference's float32 sum gives
    ucov 57603). "two_interleaved": two 330 bp genomes, two unitigs of 300
    nodes each above 2^24 whose node ids interleave. "below": the two
    genomes with counts of 1-1000."""
    rng = np.random.default_rng(11)
    if case == "one_unitig":
        genomes = [simdata.random_genome(rng, 430)]
    else:
        genomes = [simdata.random_genome(rng, 330) for _ in range(2)]
    k = 31
    reads = [g[i:i + 100] for g in genomes for i in range(len(g) - 99)]
    keys, counts, n = jcnt.count_batch(pack_reads(reads).codes, k)
    keys_h, _counts = jcnt.compact_host(keys, counts, n)
    n = len(keys_h)
    if case == "one_unitig":
        counts = coverage_counts(39, n, 50_000, 65_534, 23_040_995)
    elif case == "two_interleaved":
        counts = coverage_counts(3, n, 56_000, 65_534)
    else:
        counts = coverage_counts(4, n, 1, 1000)
    return k, keys_h, counts.astype(np.uint32)


@pytest.mark.parametrize("case", ["one_unitig", "two_interleaved", "below"])
def test_unitig_count_sums_match_reference(case):
    """ulen, ucov and _chain_pull's csum equal the JAX package's, whose
    float32 scatter-adds round once a unitig's sum passes 2^24."""
    k, keys_h, counts = _sum_graph(case)
    j = jdbg.DBG(k, keys_h, counts)
    t = interop.dbg_from_arrays(k, keys_h, counts)
    iters = max(1, math.ceil(math.log2(max(j.capacity, 2))) + 1)
    si, so, _out, od, isj = j.topo
    juid, _up, _uo, jnum, julen, jucov, jhead, jtail = (
        np.asarray(x) for x in jdbg._label_kernel(si, so, od, isj, j.alive,
                                                  j.counts, iters=iters))
    jcsum = np.asarray(jclean._chain_pull_kernel(
        si, so, od, isj, j.counts, juid, jhead, jtail)[0])
    num_u = int(jnum)
    tsi, tso, _tout, tod, tisj = t.topo
    lab = tdbg._label_core(tsi, tso, tod, tisj, t.alive, t.counts, iters)
    assert lab.num_u == num_u == (1 if case == "one_unitig" else 2)
    assert (lab.uid.numpy() == juid[:t.n]).all()
    assert (lab.ulen.numpy() == julen[:num_u]).all()
    assert (lab.ucov.numpy() == jucov[:num_u]).all()
    csum = tclean._chain_pull(t)[0]
    assert csum.dtype == torch.float32
    assert (csum.numpy() == jcsum[:num_u]).all()
    exact = tdbg._per_unitig_sum(lab.uid, t.counts, num_u)
    if case == "one_unitig":
        assert int(lab.ulen[0]) == 400 and int(exact[0]) == 23_040_995
        assert int(lab.ucov[0]) == 57603       # the exact mean rounds to 57602
    elif case == "two_interleaved":
        assert (exact > EXACT).all()
        ids = lab.uid.numpy()
        assert (np.diff(ids[ids >= 0]) != 0).sum() > 10   # interleaved
        assert (csum.double() != exact.double()).any()
    else:
        assert (exact < EXACT).all()
        assert torch.equal(csum, exact.to(torch.float32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_unitig_count_sums_plain_is_sequential_float32(seed):
    """The plain version equals a float32 sum taken one node at a time in
    id order, for interleaved unitigs above and below 2^24, nodes of no
    unitig, and a unitig with no node."""
    rng = np.random.default_rng(seed)
    n, num_u = 3000, 5
    uid = rng.integers(-1, num_u - 1, size=n)     # unitig num_u - 1 empty
    counts = rng.integers(0, 65_535, size=n)
    want = np.zeros(num_u, np.float32)
    for u, c in zip(uid, counts):
        if u >= 0:
            want[u] = np.float32(want[u] + np.float32(c))
    got = tdbg.unitig_count_sums(torch.from_numpy(uid),
                                 torch.from_numpy(counts), num_u)
    assert got.dtype == torch.float32 and (got.numpy() == want).all()
    exact = tdbg._per_unitig_sum(torch.from_numpy(uid),
                                 torch.from_numpy(counts), num_u)
    assert (exact[:num_u - 1] > EXACT).all() and int(exact[-1]) == 0


@pytest.mark.parametrize("case", ["n0", "padded", "full", "dups"])
@pytest.mark.parametrize("W", [1, 2, 3, 4, 6, 8])
def test_search_matches_reference(W, case):
    table, n, queries = search_inputs(7 * W + len(case), W, case)
    tk = tkeys.keys_from_words(table)
    tq = tkeys.keys_from_words(queries)
    assert tk.shape[1] == -(-W // 2)
    jlo, jhi = jsearch.lookup_range_jit(jnp.asarray(table),
                                        jnp.asarray(queries), jnp.int32(n))
    lo, hi = tsearch.lookup_range(tk, tq, n)
    assert (lo.numpy() == np.asarray(jlo)).all()
    assert (hi.numpy() == np.asarray(jhi)).all()
    if case == "full":
        # the reference's end rule: at or above the last row, n + 1
        assert int(hi[-2]) == n + 1 and int(hi[-3]) == n + 1
    if case != "dups":
        jl = np.asarray(jsearch.lookup(jnp.asarray(table),
                                       jnp.asarray(queries), n))
        assert (tsearch.lookup(tk, tq, n).numpy() == jl).all()
        assert (tsearch.contains(tk, tq, n).numpy() == (jl >= 0)).all()
    if case == "full":
        # an unpadded table, as the graph's node table is passed
        jl = np.asarray(jsearch.lookup(jnp.asarray(table),
                                       jnp.asarray(queries)))
        assert (tsearch.lookup(tk, tq).numpy() == jl).all()


def test_cpu_path_builds_no_kernel():
    """The CPU runs above never built or launched the card's kernels."""
    ptr = torch.tensor([-1, 0, 1])
    trank.rank_from_prev(ptr, 2)
    tdbg.unitig_count_sums(torch.tensor([0, -1, 0]), torch.tensor([1, 2, 3]),
                           1)
    tsearch.lookup_range(torch.zeros((4, 2), dtype=torch.int64),
                         torch.zeros((3, 2), dtype=torch.int64), 2)
    assert kernels._lib is None
    assert kernels.LAUNCHES["list_rank"] == 0
    assert kernels.LAUNCHES["lex_search"] == 0
    assert kernels.LAUNCHES["unitig_sum"] == 0
