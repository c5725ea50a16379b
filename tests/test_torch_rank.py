"""The labeling's list ranking and the bulk key search of the port
(ops/rank.py, models/dbg.py:_label_core, ops/search.py) against the JAX
package, exactly.

- doubling_rank_plain against models/dbg.py:_doubling_rank on seeded
  forests of chains, trees and cycles, with an `iters` cap that binds and
  one that does not, all-dead input and one long cycle;
- the port's _label_core against the JAX package's on graphs with
  junction-free cycles (which run cycle_min_pair_plain), at the default
  cap and at one that binds;
- lookup, contains and lookup_range against _lookup_jit and
  lookup_range_jit at 1-4 lanes (1-8 words), with no live row, a full
  table, duplicate runs, queries above the last row and queries equal to
  the SENTINEL.

On the CPU the wrappers take the plain versions and never build the
kernels (list_rank and lex_search run only on the card,
tests/test_torch_cuda.py).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simdata
from platanus_b_tpu.io.reads import pack_reads
from platanus_b_tpu.models import dbg as jdbg
from platanus_b_tpu.ops import count as jcnt
from platanus_b_tpu.ops import search as jsearch
from platanus_b_tpu_torch import interop, kernels
from platanus_b_tpu_torch.models import dbg as tdbg
from platanus_b_tpu_torch.ops import keys as tkeys
from platanus_b_tpu_torch.ops import rank as trank
from platanus_b_tpu_torch.ops import search as tsearch
from platanus_b_tpu_torch.simulate import label_links, search_inputs


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
    # the dispatching wrapper on CPU tensors: the same, with its stats
    wp, wr, wa, stats = trank.doubling_rank(*args, iters)
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
    trank.doubling_rank(ptr, (ptr >= 0).long(), torch.tensor([0, 0, 1]), 2)
    tsearch.lookup_range(torch.zeros((4, 2), dtype=torch.int64),
                         torch.zeros((3, 2), dtype=torch.int64), 2)
    assert kernels._lib is None
    assert kernels.LAUNCHES["list_rank"] == 0
    assert kernels.LAUNCHES["lex_search"] == 0
