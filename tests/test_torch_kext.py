"""The port's next-k contig table, laid out on the device, against the host.

`save_contig_next_k` and `count_from_contigs` build kmerize's buffer with
device gathers (assemble_core.lay_out_sequences). The oracle here is the
host path they replaced: per-unitig probes copied to the host, extended
by numpy ragged fills, then filled into an N-separated buffer. The
layout must give its bytes exactly, and the tables must equal the JAX
package's on the same graph (node ids are equal on both sides).
"""

import numpy as np
import pytest
import torch

import simdata
from platanus_b_tpu.commands import merge_cmd as jmerge
from platanus_b_tpu.io.reads import pack_reads
from platanus_b_tpu.models import assemble_core as jcore
from platanus_b_tpu.models.dbg import DBG as JDBG
from platanus_b_tpu.ops import count as jcnt
from platanus_b_tpu_torch import interop
from platanus_b_tpu_torch.models import assemble_core as tcore
from platanus_b_tpu_torch.ops import count as tcnt
from platanus_b_tpu_torch.utils.log import LOG

BASES = "ACGT"


# ---------------------------------------------------------------------------
# the host oracle
# ---------------------------------------------------------------------------

def _ragged_fill(dst, dst_starts, lens, src, src_starts, step=1,
                 comp=False) -> None:
    """dst[dst_starts[i]+t] = src[src_starts[i] + step*t] (optionally
    complemented) for t < lens[i] (assemble_core.py:476)."""
    lens = np.asarray(lens, dtype=np.int64)
    sel = lens > 0
    if not sel.any():
        return
    ds = np.asarray(dst_starts, dtype=np.int64)[sel]
    ss = np.asarray(src_starts, dtype=np.int64)[sel]
    ln = lens[sel]
    cum = np.zeros(len(ln) + 1, np.int64)
    cum[1:] = np.cumsum(ln)
    within = np.arange(cum[-1], dtype=np.int64) - np.repeat(cum[:-1], ln)
    dpos = np.repeat(ds, ln) + within
    spos = np.repeat(ss, ln) + (within if step == 1 else -within)
    v = src[spos]
    if comp:
        v = (3 - v).astype(np.uint8)
    dst[dpos] = v


def extended_unitig_sequences_flat(dbg, diff: int):
    """The extended unitig sequences by host ragged fills over one flat
    buffer. Returns (flat uint8, offs (U,), lens (U,), ucov (U,) uint32)."""
    lab = dbg.label_unitigs_device()
    U = lab.num_u
    if U == 0:
        return (np.zeros(0, np.uint8), np.zeros(0, np.int64),
                np.zeros(0, np.int64), np.zeros(0, np.uint32))
    flat, offs, base_lens = dbg.unitig_sequences_flat()
    (hasL, jbL, exL, sameL, uid2L,
     hasR, jbR, exR, sameR, uid2R) = [
        x.cpu().numpy() for x in tcore._ext_probe(dbg, diff)]
    ucov = lab.ucov.cpu().numpy().astype(np.uint32)
    jbL = jbL.astype(np.uint8)
    jbR = jbR.astype(np.uint8)
    k = dbg.k

    hL = hasL.astype(np.int64)
    hR = hasR.astype(np.int64)
    ext_lens = exL + hL + base_lens + hR + exR
    ext_offs = np.zeros(U, np.int64)
    ext_offs[1:] = np.cumsum(ext_lens)[:-1]
    out = np.empty(int(ext_lens.sum()), np.uint8)

    o2L = offs[np.clip(uid2L, 0, U - 1)]
    l2L = base_lens[np.clip(uid2L, 0, U - 1)]
    _ragged_fill(out, ext_offs, np.where(sameL, exL, 0),
                 flat, o2L + l2L - (k - 1) - exL)
    _ragged_fill(out, ext_offs, np.where(~sameL, exL, 0),
                 flat, o2L + (k - 1) + exL - 1, step=-1, comp=True)
    posL = ext_offs + exL
    out[posL[hasL]] = jbL[hasL]
    mid = ext_offs + exL + hL
    _ragged_fill(out, mid, base_lens, flat, offs)
    posR = mid + base_lens
    out[posR[hasR]] = jbR[hasR]
    o2R = offs[np.clip(uid2R, 0, U - 1)]
    l2R = base_lens[np.clip(uid2R, 0, U - 1)]
    startR = posR + hR
    _ragged_fill(out, startR, np.where(sameR, exR, 0),
                 flat, o2R + l2R - k, step=-1, comp=True)
    _ragged_fill(out, startR, np.where(~sameR, exR, 0),
                 flat, o2R + (k - 1))
    return out, ext_offs, ext_lens, ucov


def kmerize_buffer(flat, offs, lens, k: int):
    """kmerize's N-separated buffer of the sequences of k bases or more,
    and the sequence of each position before the padding."""
    lens = np.asarray(lens, np.int64)
    sel = np.flatnonzero(lens >= k)
    ln = lens[sel]
    starts = np.cumsum(ln + 1) - (ln + 1)
    total = int((ln + 1).sum())
    buf = np.full(-(-total // 32) * 32, 4, dtype=np.uint8)
    _ragged_fill(buf, starts, ln, flat, np.asarray(offs, np.int64)[sel])
    seq_of = sel[np.searchsorted(starts, np.arange(total), side="right") - 1]
    return buf, seq_of, total


# ---------------------------------------------------------------------------
# graphs
# ---------------------------------------------------------------------------

def _branchy_reads(seed):
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list(BASES), size=800))
    # mutated copies make bubbles and branches: junctions
    g2 = list(genome)
    for p in rng.integers(50, 750, size=6):
        g2[p] = BASES[(BASES.index(g2[p]) + 1) % 4]
    g2 = "".join(g2)
    reads = [genome[i:i + 60] for i in range(0, len(genome) - 60, 3)]
    return reads + [g2[i:i + 60] for i in range(0, len(g2) - 60, 7)]


def _repeat_reads():
    rng = np.random.default_rng(42)
    core = "".join(rng.choice(list(BASES), size=120))
    a, b, c, d = ("".join(rng.choice(list(BASES), size=200))
                  for _ in range(4))
    genome = a + core + b + c + core + d
    return [genome[i:i + 50] for i in range(0, len(genome) - 50, 2)]


def _reads(name):
    if name == "repeat":
        return _repeat_reads()
    if name == "short":
        # one unitig of 40 bases and no junction
        g = simdata.random_genome(np.random.default_rng(5), 40)
        return [g[i:i + 30] for i in range(0, 11)]
    if name == "errors":
        rng = np.random.default_rng(11)
        g = simdata.random_genome(rng, 900)
        return simdata.shotgun_reads(rng, g, 70, 30.0, error_rate=0.01)
    return _branchy_reads(int(name[-1]))


def _pair(name, k=15):
    batch = pack_reads(_reads(name))
    keys, counts, n = jcnt.count_batch(batch.codes, k)
    keys_h, counts_h = jcnt.compact_host(keys, counts, n)
    return (JDBG(k, keys_h, counts_h),
            interop.dbg_from_arrays(k, keys_h, counts_h))


def _assert_layout_is_oracle(dbg, next_k):
    flat, offs, lens, _cov = extended_unitig_sequences_flat(dbg,
                                                            next_k - dbg.k)
    buf, seq_of, total = kmerize_buffer(flat, offs, lens, next_k)
    lay = tcore.extended_unitig_layout(dbg, next_k)
    if total == 0:
        assert lay is None
        return flat, offs, lens
    assert lay.total == total
    assert lay.codes.dtype == torch.uint8
    assert np.array_equal(lay.codes.cpu().numpy()[0], buf)
    assert np.array_equal(lay.seq_of.cpu().numpy(), seq_of)
    return flat, offs, lens


# ---------------------------------------------------------------------------
# the layout, byte for byte
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("diff", [5, 10, 40])
@pytest.mark.parametrize("name", ["random0", "random1", "random2", "random3"])
def test_layout_is_the_host_fill_random(name, diff):
    j, t = _pair(name)
    assert t.topo[4].any(), "expected junctions"
    flat, offs, lens = _assert_layout_is_oracle(t, t.k + diff)
    # the oracle itself is the JAX package's extended sequences
    jflat, joffs, jlens, _c = jcore.extended_unitig_sequences_flat(j, diff)
    assert np.array_equal(lens, jlens) and np.array_equal(offs, joffs)
    assert np.array_equal(flat, jflat)


@pytest.mark.parametrize("diff", [5, 20])
def test_layout_is_the_host_fill_repeat_genome(diff):
    j, t = _pair("repeat")
    flat, _offs, _lens = _assert_layout_is_oracle(t, t.k + diff)
    jflat, _o, _l, _c = jcore.extended_unitig_sequences_flat(j, diff)
    assert np.array_equal(flat, jflat)


def test_layout_of_a_graph_with_no_unitigs():
    _j, t = _pair("random0")
    t.delete_nodes(torch.ones(t.n, dtype=torch.bool))
    assert t.label_unitigs_device().num_u == 0
    flat, _offs, _lens, _cov = extended_unitig_sequences_flat(t, 10)
    assert len(flat) == 0
    tab = tcore.save_contig_next_k(t, t.k + 10, 0.5)
    assert len(tab) == 0


def test_layout_of_sequences_all_shorter_than_next_k():
    j, t = _pair("short")
    _flat, _offs, lens = _assert_layout_is_oracle(t, t.k + 40)
    assert len(lens) and (lens < t.k + 40).all()
    assert len(tcore.save_contig_next_k(t, t.k + 40, 1.0)) == 0
    assert len(jcore.save_contig_next_k(j, j.k + 40, 1.0)) == 0


def test_layout_reads_the_reverse_complement_of_a_far_unitig():
    # a piece read backwards, complemented, and a constant between
    flat = torch.tensor([0, 1, 2, 3, 0, 0, 1], dtype=torch.uint8)
    plen = torch.tensor([[3, 1, 2], [0, 0, 1]])
    psrc = torch.tensor([[3, 0, 5], [0, 0, 0]])
    prc = torch.tensor([[True, False, False], [False, False, False]])
    pconst = torch.tensor([[-1, 2, -1], [-1, -1, -1]])
    lay = tcore.lay_out_sequences(flat, plen, psrc, prc, pconst, 6)
    assert lay.total == 7
    assert lay.codes.tolist() == [[0, 1, 2, 2, 0, 1, 4] + [4] * 25]
    assert lay.seq_of.tolist() == [0] * 7


# ---------------------------------------------------------------------------
# the tables
# ---------------------------------------------------------------------------

def _same_table(jtab, ttab):
    jtab = jtab.host()
    tkeys, tcounts = ttab.host_words()
    assert np.array_equal(tkeys, np.asarray(jtab.keys))
    assert np.array_equal(tcounts, np.asarray(jtab.counts, np.uint32))


@pytest.mark.parametrize("name,next_k,ratio", [
    ("random0", 25, 0.5), ("random2", 55, 0.8), ("repeat", 20, 1.0),
    ("errors", 31, 0.731), ("errors", 15, 1.0)])
def test_save_contig_next_k_is_the_jax_table(name, next_k, ratio):
    j, t = _pair(name)
    assert len(t.label_unitigs().ulen) > 1
    _same_table(jcore.save_contig_next_k(j, next_k, ratio),
                tcore.save_contig_next_k(t, next_k, ratio))


def _contigs(seed, n, with_short):
    rng = np.random.default_rng(seed)
    seqs = [rng.integers(0, 4, size=int(rng.integers(20, 300)),
                         dtype=np.uint8) for _ in range(n)]
    seqs.append(seqs[0][10:90].copy())         # a shared stretch: max rule
    if with_short:
        seqs += [rng.integers(0, 4, size=5, dtype=np.uint8),
                 np.zeros(0, np.uint8)]
    covs = rng.uniform(0.0, 80.0, size=len(seqs))
    covs[-1] = 70000.0                        # saturates
    return seqs, covs


@pytest.mark.parametrize("k,min_occ,with_short", [
    (21, 1, False), (31, 5, True), (63, 2, True)])
def test_count_from_contigs_is_the_jax_table(k, min_occ, with_short):
    seqs, covs = _contigs(k, 30, with_short)
    _same_table(jmerge.count_from_contigs(seqs, covs, k, min_occ),
                tcore.count_from_contigs(seqs, covs, k, min_occ, "cpu"))


def test_count_from_contigs_with_no_contig_of_k_bases():
    seqs = [np.zeros(10, np.uint8), np.ones(20, np.uint8)]
    tab = tcore.count_from_contigs(seqs, [3.0, 4.0], 21, 1, "cpu")
    assert len(tab) == 0


def test_unitig_sequences_record_counts_sequences_and_bases():
    _j, t = _pair("random1")
    next_k = t.k + 10
    flat, offs, lens, _cov = extended_unitig_sequences_flat(t, 10)
    _buf, _seq_of, total = kmerize_buffer(flat, offs, lens, next_k)
    LOG.reset()
    with LOG.stage("  save contig next-k"):
        tcore.save_contig_next_k(t, next_k, 0.5)
    rec = {s.name: s for s in LOG.spans}
    counters = rec["    unitig sequences"].counters
    assert counters == {"sequences": len(lens), "bases": total}
    assert rec["    kmerize"].counters == {}
    LOG.reset()


def test_dedup_max_keeps_each_run_maximum():
    keys = torch.tensor([[5], [3], [5], [3], [9]])
    vals = torch.tensor([1, 7, 4, 2, 0])
    uk, uv, n = tcnt.dedup_max(keys, vals)
    assert n == 3 and uk[:, 0].tolist() == [3, 5, 9]
    assert uv.tolist() == [7, 4, 0]
