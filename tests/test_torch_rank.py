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

import torch_threads  # noqa: F401  (first: sets torch's CPU threads)

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


def test_unitig_count_sums_with_ulen_on_cpu():
    """On the CPU, unitig_count_sums(..., with_ulen=True) gives the plain
    sums and the exact node counts, those of _per_unitig_sum."""
    rng = np.random.default_rng(5)
    uid = torch.from_numpy(rng.integers(-1, 40, size=4000))
    counts = torch.from_numpy(rng.integers(0, 1 << 20, size=4000))
    csum, ulen = tdbg.unitig_count_sums(uid, counts, 41, True)
    assert torch.equal(csum, tdbg.unitig_count_sums_plain(uid, counts, 41))
    assert ulen.dtype == torch.int64 and int(ulen[40]) == 0
    assert torch.equal(ulen, tdbg._per_unitig_sum(uid, torch.ones_like(uid),
                                                  41))
    assert torch.equal(tdbg.unitig_count_sums(uid, counts, 41), csum)


# A model of csrc/unitig_sum.cu's long path in numpy: chunk transfers
# (each lane's run of values composed in order, then an ordered tree over
# the 32 lanes), the binade guessed from the exact prefix, and the walk
# that takes a transfer or replays the chunk with float32 adds.
TOP = 1 << 24
VALUE_CAP = 1 << 31


def _transfer_add(t, x, j):
    i0, i1, e0, e1, ok = t
    if not (x >= 0 and x < VALUE_CAP):
        return (i0, i1, e0, e1, False)
    X = int(x)
    if j == 0:
        return (i0 + X, i1 + X, e0, e1, ok)
    q, r, half = X >> j, X & ((1 << j) - 1), 1 << (j - 1)
    d0 = q + (r > half or (r == half and (e0 + q) & 1 == 1))
    d1 = q + (r > half or (r == half and (e1 + q) & 1 == 1))
    return (i0 + d0, i1 + d1, (e0 + d0) & 1, (e1 + d1) & 1, ok)


def _compose(a, b):
    i0, i1, e0, e1, ok = a
    bi = (b[0], b[1])
    be = (b[2], b[3])
    return (i0 + bi[e0], i1 + bi[e1], be[e0], be[e1], ok and b[4])


def _chunk_transfer(chunk, j):
    per = max(1, len(chunk) // 32 + (len(chunk) % 32 > 0))
    lanes = []
    for lane in range(32):
        t = (0, 0, 0, 1, True)
        for x in chunk[lane * per:(lane + 1) * per]:
            t = _transfer_add(t, x, j)
        lanes.append(t)
    d = 1
    while d < 32:
        for lane in range(0, 32, 2 * d):
            lanes[lane] = _compose(lanes[lane], lanes[lane + d])
        d *= 2
    return lanes[0]


def _to_float(j, k, other):
    if j < 0:
        return other
    return np.float32(k * 2 ** j)


def _from_float(s):
    if not s >= 0 or np.isinf(s):
        return -1, 0, s
    if s < TOP:
        return 0, int(s), s
    m, e = math.frexp(float(s))
    return e - 24, int(m * TOP), s


def _records(vals, C):
    """Each chunk's (increment from parity 0, from 1, guess, ok), the
    increments capped at 2^24, as the kernel stores them."""
    prefix, out = 0, []
    for at in range(0, len(vals), C):
        chunk = vals[at:at + C]
        jg = 0 if prefix < TOP else prefix.bit_length() - 24
        prefix += sum(max(min(int(x), VALUE_CAP - 1), 1 - VALUE_CAP)
                      for x in chunk)
        i0, i1, _e0, _e1, ok = _chunk_transfer(chunk, jg)
        out.append((min(i0, TOP), min(i1, TOP), jg, ok))
    return out


def _chunked_fold(vals, C):
    """(float32 sum, chunks replayed, walk steps) of vals (float32) by the
    model: steps of up to 32 chunks, whose transfers a warp scan composes
    in order; the first chunk that cannot be taken is replayed."""
    rec = _records(vals, C)
    j, k, other = 0, 0, np.float32(0)
    replays = steps = 0
    for cb in range(0, len(rec), 32):
        batch = rec[cb:cb + 32]
        start = 0
        while start < len(batch):
            steps += 1
            kl, t0, t1, bad = [], 0, 0, None
            for lane, (i0, i1, jg, ok) in enumerate(batch):
                if lane >= start:
                    t0, t1 = (t0 + (i1 if t0 & 1 else i0),
                              t1 + (i0 if t1 & 1 else i1))
                kl.append(k + (t1 if k & 1 else t0))
                if lane >= start and bad is None and not (
                        ok and j >= 0 and jg == j and kl[-1] < TOP):
                    bad = lane
            if bad is None:
                k = kl[-1]
                break
            if bad > start:
                k = kl[bad - 1]
            s = _to_float(j, k, other)
            for x in vals[(cb + bad) * C:(cb + bad + 1) * C]:
                s = np.float32(s + x)
            j, k, other = _from_float(s)
            replays += 1
            start = bad + 1
    return _to_float(j, k, other), replays, steps


def _sequential_float32(vals):
    s = np.zeros(1, np.float32)
    np.add.at(s, np.zeros(len(vals), np.int64), vals)
    return s[0]


def _fold_case(case, C):
    rng = np.random.default_rng(len(case) + C)
    if case == "ties":                        # ulp 2, every count odd
        v = np.concatenate([[TOP - 1], 2 * rng.integers(0, 50, 3000) + 1])
    elif case == "crossing":                  # passes 2^24 once
        v = rng.integers(800, 1001, 20_000)
    elif case == "ends_at_2p24":              # a chunk ends on 2^24
        head = rng.integers(0, 100, 2 * C - 1)
        v = np.concatenate([head, [TOP - int(head.sum())],
                            2 * rng.integers(0, 50, 3 * C + 5) + 1])
    elif case == "above_2p24":                # counts past 2^24 and 2^31
        v = rng.integers(0, 1000, 4000)
        v[rng.choice(4000, 40, replace=False)] = rng.integers(
            TOP, 1 << 27, 40)
        v[rng.choice(4000, 3, replace=False)] = (1 << 33) + 5
    elif case == "negative":
        v = rng.integers(60, 100, 6000)
        v[rng.choice(6000, 5, replace=False)] = [-1, -7, -(1 << 22), -99, -3]
        v[0] = -5
        v = np.concatenate([[TOP + 3], v])
    elif case == "empty":
        v = np.zeros(0, np.int64)
    else:                                     # binade walk: to 2^32
        v = (2.0 ** rng.uniform(0, 20, 5000)).astype(np.int64)
    return np.asarray(v, np.int64).astype(np.float32)


@pytest.mark.parametrize("C", [1, 7, 256, 512])
@pytest.mark.parametrize("case", ["ties", "crossing", "ends_at_2p24",
                                  "above_2p24", "negative", "empty",
                                  "binade_walk"])
def test_chunked_fold_model_is_sequential_float32(case, C):
    """The long path's fold (chunk transfers at the binade the exact prefix
    guesses, then a walk that replays any chunk it cannot take) equals the
    sequential float32 sum bit for bit, and takes most chunks whole."""
    v = _fold_case(case, C)
    got, replays, steps = _chunked_fold(v, C)
    want = _sequential_float32(v)
    assert np.float32(got).tobytes() == want.tobytes()
    if case != "empty":
        exact = int(np.asarray(v, np.float64).sum())
        if case in ("ties", "crossing", "binade_walk"):
            assert float(want) != exact           # the rounding shows
        if case in ("ties", "crossing", "binade_walk") and C == 256:
            assert replays <= 4
            assert steps <= -(-len(v) // (32 * C)) + replays
    if case == "ends_at_2p24":
        assert float(_sequential_float32(v[:2 * C])) == TOP


def test_chunked_fold_model_on_random_counts():
    """The model against the sequential float32 sum on random counts,
    mixed in size and sign, at chunk sizes 1, 7 and 256."""
    from hypothesis import given, settings
    from hypothesis import strategies as st
    counts = st.one_of(st.integers(0, 99), st.integers(0, 1 << 20),
                       st.integers(TOP - 50, TOP + 50),
                       st.integers(-(1 << 10), 1 << 34))

    @settings(max_examples=60, deadline=None, derandomize=True,
              database=None)
    @given(st.lists(counts, max_size=600), st.sampled_from([1, 7, 256]),
           st.integers(0, 1 << 25))
    def check(vals, C, start):
        v = np.asarray([start] + vals, np.int64).astype(np.float32)
        got, _replays, _steps = _chunked_fold(v, C)
        assert np.float32(got).tobytes() == _sequential_float32(v).tobytes()

    check()


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
