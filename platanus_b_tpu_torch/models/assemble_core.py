"""The `assemble` pipeline: reads -> contigs via iterative k extension.

Counterpart of platanus_b_tpu/models/assemble_core.py (Assemble::exec,
assemble.cpp:140-265). Reads are staged once on the device as a padded
code matrix; every counting pass packs them to 2 bits per base on the
device and extracts windows with the kmer_extract kernel. Tables are
sorted, trimmed (n, L) lane tensors; there is one counting path (a single
sort of the whole window stream), no chunked fold.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..io.reads import ReadBatch, load_read_batches
from ..ops import count as cnt
from ..ops.keys import (is_sentinel, keys_from_words, keys_to_words,
                        lanes_to_words, num_lanes, num_words)
from ..ops.kmer import extract_kmers_packed, kmer_to_codes, pack_codes
from ..ops.search import lookup
from ..parallel import multihost as mh
from ..utils.log import LOG
from . import clean
from .clean import _first_target
from .dbg import DBG


@dataclass
class KmerTable:
    """Sorted unique canonical k-mers (n, L) int64 lanes + occurrence
    values (n,) int64, on one device."""

    k: int
    keys: torch.Tensor
    counts: torch.Tensor

    def __len__(self) -> int:
        return int(self.keys.shape[0])

    def host_words(self) -> tuple[np.ndarray, np.ndarray]:
        """(keys (n, W) uint32 words, counts (n,) uint32) on the host."""
        return (keys_to_words(self.keys, self.k),
                self.counts.cpu().numpy().astype(np.uint32))


def empty_table(k: int, device) -> KmerTable:
    return KmerTable(k, torch.zeros((0, num_lanes(k)), dtype=torch.int64,
                                    device=device),
                     torch.zeros(0, dtype=torch.int64, device=device))


# ---------------------------------------------------------------------------
# reads staged on the device
# ---------------------------------------------------------------------------

@dataclass
class StagedReads:
    """All reads as one (R, L) uint8 code matrix on the device (L a
    multiple of 32, padding = 4) + lengths. Packed to 2 bits per base
    (words + N bit-mask, the ReadBatch.packed() layout) on demand."""

    codes: torch.Tensor
    lengths: torch.Tensor     # (R,) int32
    has_n: bool               # an N inside some read: use the N bit-mask
    max_len: int              # windows end before this column
    _packed: tuple | None = None

    @property
    def num_reads(self) -> int:
        return int(self.codes.shape[0])

    @property
    def device(self) -> torch.device:
        return self.codes.device

    def packed(self):
        if self._packed is None:
            self._packed = pack_codes(self.codes)
        return self._packed

    def kmers(self, k: int, forward_only: bool = False):
        """(keys (R, P, L), n_valid (1,)) of every window, via kmer_extract."""
        words, nmask = self.packed()
        if self.has_n:
            return extract_kmers_packed(words, k, nmask=nmask,
                                        max_len=self.max_len,
                                        forward_only=forward_only)
        return extract_kmers_packed(words, k, lengths=self.lengths,
                                    max_len=self.max_len,
                                    forward_only=forward_only)

    def select(self, mask: torch.Tensor) -> "StagedReads":
        return StagedReads(self.codes[mask], self.lengths[mask], self.has_n,
                           self.max_len)


def stage_reads(batches: list[ReadBatch], device) -> StagedReads:
    """Concatenate read batches into one padded matrix on the device."""
    live = [b for b in batches if b.num_reads]
    max_len = max((b.max_len for b in live), default=0)
    width = max(-(-max_len // 32) * 32, 32)
    rows = sum(b.num_reads for b in live)
    mat = np.full((rows, width), 4, dtype=np.uint8)
    lens = np.zeros(rows, dtype=np.int32)
    r = 0
    for b in live:
        mat[r: r + b.num_reads, : b.max_len] = b.codes
        lens[r: r + b.num_reads] = b.lengths
        r += b.num_reads
    return StagedReads(torch.from_numpy(mat).to(device),
                       torch.from_numpy(lens).to(device),
                       any(b.has_n for b in live), max_len)


def stage_read_files(paths: list[str], device) -> StagedReads:
    """Read files (FASTA/FASTQ) staged on the device, as assemble reads them."""
    return stage_reads(list(load_read_batches(paths)), device)


def count_reads_device(reads: StagedReads, k: int):
    """Count canonical k-mers of all reads in one sort (the JAX package's
    fused path, count_staged / count_lanes_fused). Returns (keys (n, L),
    counts (n,), n, histogram (host int32))."""
    dev = reads.device
    if reads.num_reads == 0 or reads.max_len < k:
        t = empty_table(k, dev)
        return (t.keys, t.counts, 0,
                np.zeros(cnt.MAX_OCCURRENCE + 1, np.int32))
    keys, n_valid = reads.kmers(k)
    ukeys, ucounts, n = cnt.count_lanes_fused(
        keys.reshape(-1, keys.shape[-1]), n_valid=n_valid)
    del keys
    hist = cnt.histogram_host(cnt.occurrence_histogram(ucounts))
    return ukeys, ucounts, n, hist


def _host_table(keys: torch.Tensor, counts: torch.Tensor, k: int):
    """A table as the ranks exchange it: ((n, W) uint32 words, (n,) uint32
    counts saturated at MAX_OCCURRENCE)."""
    return (keys_to_words(keys, k),
            counts.clamp(max=cnt.MAX_OCCURRENCE).cpu().numpy()
            .astype(np.uint32))


def _gather_table(k: int, keys: np.ndarray, counts: np.ndarray,
                  device) -> KmerTable:
    """Every rank's key-range slice (host words), concatenated in rank
    order, which is the sorted global table, on `device`."""
    return KmerTable(k, keys_from_words(mh.all_hosts_concat(keys), device),
                     torch.from_numpy(mh.all_hosts_concat(counts)
                                      .astype(np.int64)).to(device))


def _shard_histogram(counts: np.ndarray) -> np.ndarray:
    """Global histogram from key-range shards: each unique key lives in
    exactly one shard, so it is the sum of the shards' histograms."""
    local = cnt.occurrence_histogram(torch.from_numpy(counts.astype(np.int64)))
    return mh.psum_histogram(cnt.histogram_host(local)).astype(np.int32)


def count_reads(reads: StagedReads, k: int) -> tuple[KmerTable, np.ndarray]:
    """The global table of every rank's reads (assemble_core.py:270): each
    rank counts its own reads, the key-range sharded merge reduces each
    range on its owner, the histogram is the sum of the shards', and the
    shards concatenate in rank order into the sorted table, replicated.
    Single-process it is count_reads_device. A rank with no reads still
    enters every collective."""
    keys, counts, _n, hist = count_reads_device(reads, k)
    if mh.process_count() == 1:
        return KmerTable(k, keys, counts), hist
    sk, sc = mh.global_count_merge_sharded(*_host_table(keys, counts, k), k=k)
    return _gather_table(k, sk, sc, reads.device), _shard_histogram(sc)


# ---------------------------------------------------------------------------
# k-extension schedule (assemble.cpp:657-736), lifted unchanged
# ---------------------------------------------------------------------------

def calc_log_probability_join(coverage_cutoff: int, average_coverage: float,
                              average_length: float, large_k: int,
                              small_k: int) -> float:
    """assemble.cpp:700-716: log P(all junction k-mers survive the cutoff),
    Poisson with mean = k-mer coverage at large_k."""
    lam = average_coverage * (average_length - large_k + 1.0) / average_length
    s = 0.0
    for i in range(int(coverage_cutoff)):
        p = 0.0
        for j in range(1, i + 1):
            p += math.log(lam) - math.log(j)
        s += math.exp(p)
    s = math.exp(-lam + math.log(s)) if s > 0 else 0.0
    return ((large_k - small_k) + 1.0) * (-s)


def decrease_coverage_cutoff(coverage_cutoff: int, average_coverage: float,
                             average_length: float, min_log_p_join: float,
                             large_k: int, small_k: int) -> int:
    """assemble.cpp:723-736."""
    if coverage_cutoff <= 1:
        return 1
    i = coverage_cutoff
    while i > 1:
        if calc_log_probability_join(i, average_coverage, average_length,
                                     large_k, small_k) > min_log_p_join:
            break
        i -= 1
    return i


def extend_kmer_schedule(min_log_p_join: float, average_coverage: float,
                         average_length: float, min_coverage: int,
                         k0: int, cutoff0: int, length_step: int,
                         max_kmer_ratio: float) -> tuple[list[int], list[int]]:
    """extendKmer (assemble.cpp:657-696): grow k by up to length_step while
    the join probability stays above min_log_p_join."""
    ks = [k0]
    cutoffs = [cutoff0]
    min_max_k = int(average_length * max_kmer_ratio + 0.5)
    LOG.info("\nKMER_EXTENSION:")
    LOG.info(f"K={k0}, KMER_COVERAGE="
             f"{average_coverage * (average_length - k0 + 1.0) / average_length:.3g}"
             f" (>= {cutoff0}), COVERAGE_CUTOFF={cutoff0}")
    while ks[-1] <= average_length:
        prev_k, prev_cut = ks[-1], cutoffs[-1]
        k_i = prev_k
        cut_i = prev_cut
        for j in range(1, length_step + 2):
            k_i = prev_k + j
            cut_i = decrease_coverage_cutoff(prev_cut, average_coverage,
                                             average_length, min_log_p_join,
                                             k_i, prev_k)
            cut_i = max(cut_i, min_coverage)
            if (prev_k + j > min_max_k
                    and calc_log_probability_join(cut_i, average_coverage,
                                                  average_length, k_i, prev_k)
                    < min_log_p_join):
                break
        k_i -= 1
        cut_i = max(decrease_coverage_cutoff(prev_cut, average_coverage,
                                             average_length, min_log_p_join,
                                             k_i, prev_k), min_coverage)
        if k_i == prev_k:
            break
        ks.append(k_i)
        cutoffs.append(cut_i)
        LOG.info(f"K={k_i}, KMER_COVERAGE="
                 f"{average_coverage * (average_length - k_i + 1.0) / average_length:.3g}"
                 f", COVERAGE_CUTOFF={cut_i}")
    return ks, cutoffs


# ---------------------------------------------------------------------------
# contig-derived next-k table (saveContig, graph.h:1655-1771)
# ---------------------------------------------------------------------------

@dataclass
class Layout:
    """Sequences laid end to end in one (1, width) uint8 code row, each
    followed by one N (code 4), width padded to a multiple of 32 with N:
    kmerize's buffer. seq_of (total,) is the sequence of each position
    (its index among the sequences the layout was given)."""

    codes: torch.Tensor
    seq_of: torch.Tensor
    total: int


def lay_out_sequences(flat: torch.Tensor, plen: torch.Tensor,
                      psrc: torch.Tensor, prc: torch.Tensor,
                      pconst: torch.Tensor, k: int) -> Layout | None:
    """Build kmerize's buffer on the device from pieces.

    Sequence s is its P pieces in order, row s of the (S, P) tensors:
    piece j has plen[s, j] bases, each either the constant pconst[s, j]
    (where it is >= 0) or a gather from flat: flat[psrc + t] for t <
    plen, or, where prc, the complement of flat[psrc - t] (a reverse
    complement read backwards from psrc). Sequences shorter than k are
    left out. One scalar is read to size the buffer; None when no
    sequence has k bases."""
    P = plen.shape[1]
    dev = flat.device
    keep = plen.sum(dim=1) >= k
    seg = torch.cat([plen, torch.ones_like(plen[:, :1])], dim=1)
    seg = torch.where(keep[:, None], seg, 0).reshape(-1)
    total = int(seg.sum())
    if total == 0:
        return None
    # piece of every position, then its offset t inside the piece
    pid = torch.repeat_interleave(seg, output_size=total)
    t = torch.arange(total, device=dev) - (torch.cumsum(seg, 0) - seg)[pid]

    def col(x, last):
        """Piece column x with the separator's value, at every position."""
        x = torch.cat([x, torch.full_like(x[:, :1], last)], dim=1)
        return x.reshape(-1)[pid]

    rc = col(prc, False)
    src = col(psrc, 0) + torch.where(rc, -t, t)
    del t
    base = flat[src.clamp_(0, flat.numel() - 1)]
    base = torch.where(rc & (base < 4), 3 - base, base)
    const = col(pconst, 4)
    width = -(-total // 32) * 32
    codes = torch.full((1, width), 4, dtype=torch.uint8, device=dev)
    codes[0, :total] = torch.where(const >= 0, const, base)
    return Layout(codes, pid // (P + 1), total)


def kmerize_layout(lay: Layout | None, vals: torch.Tensor, k: int,
                   device) -> KmerTable:
    """Canonical k-mers of a layout's sequences, value = MAX over
    occurrences of vals[s] of the sequence s holding them (the saveContig
    and mergeContig rule, graph.h:1760-1765, counter.h:511-593).

    A window that crosses a separator is invalid, so the whole set is one
    kmer_extract pass. This gives the same (key, max value) set as the
    JAX package's fixed-width segment rows (assemble_core.py:644-710)."""
    if lay is None:
        return empty_table(k, device)
    words, nmask = pack_codes(lay.codes)
    keys, _n_valid = extract_kmers_packed(words, k, nmask=nmask,
                                          max_len=lay.total)
    keys = keys[0]
    idx = torch.nonzero(~is_sentinel(keys))[:, 0]
    uk, uv, _n = cnt.dedup_max(keys[idx], vals[lay.seq_of[idx]])
    return KmerTable(k, uk, uv)


def _ext_probe(dbg: DBG, diff: int):
    """assemble_core.py:500 _ext_probe_kernel: per-unitig junction and
    far-side probes (graph.h:1678-1751 walks) as device gathers. Returns
    device tensors (U,): for the left end then the right, (has junction
    base, junction base, far bases taken, far unitig stored in the same
    orientation, far unitig id clamped to 0..U-1)."""
    si, so, _out, od, isj = dbg.topo
    lab = dbg.label_unitigs_device()
    n = dbg.n
    U = lab.num_u
    k = dbg.k
    W = num_words(k)
    g = 2 * (k - 1)

    def jbase(jn, orient, first):
        key = lanes_to_words(dbg.keys[jn], W)
        fb = (key[:, W - 1 - g // 32] >> (g % 32)) & 3
        lb = key[:, W - 1] & 3
        if first:
            return torch.where(orient == 0, fb, 3 - lb)
        return torch.where(orient == 0, lb, 3 - fb)

    def probe(node, look):
        deg = torch.where(look == 0, od[0][node], od[1][node])
        jn, jt = _first_target(si, so, look, node)
        jn_c = jn.clamp(0, n - 1)
        has_j = (deg == 1) & (jn >= 0) & isj[jn_c]
        deg2 = torch.where(jt == 0, od[0][jn_c], od[1][jn_c])
        cond_c = has_j & (deg2 == 1)
        fn, fo = _first_target(si, so, jt, jn_c)
        fn_c = fn.clamp(0, n - 1)
        has_far = cond_c & (fn >= 0) & ~isj[fn_c] & (lab.uid[fn_c] >= 0)
        return has_j, jn_c, jt, has_far, fn_c, fo

    out = []
    for left, ends in ((True, lab.uhead), (False, lab.utail)):
        node, o = ends >> 1, ends & 1
        has, jn, jt, far, fn, fo = probe(node, 1 - o if left else o)
        jb = jbase(jn, 1 - jt if left else jt, left)
        uid2 = lab.uid[fn].clamp(0, U - 1)
        ex = torch.where(far, torch.clamp(lab.ulen[uid2], max=diff), 0)
        t2 = lab.utail[uid2]
        same = ((t2 >> 1) == fn) & ((t2 & 1) == (1 - fo))
        out += [has, jb, ex, same, uid2]
    return out


def extended_unitig_layout(dbg: DBG, next_k: int) -> Layout | None:
    """Unitig sequences extended through their end junctions by up to
    diff = next_k - k bases of the far unitig (assemble_core.py:566), laid
    out for kmerize straight from the device flat of
    unitig_sequences_flat_device. Each unitig is five pieces: far-left
    part, left junction base, its own bases, right junction base,
    far-right part."""
    flat, offs, base_lens = dbg.unitig_sequences_flat_device()
    k = dbg.k
    (hasL, jbL, exL, sameL, uid2L,
     hasR, jbR, exR, sameR, uid2R) = _ext_probe(dbg, next_k - k)
    o2L, l2L = offs[uid2L], base_lens[uid2L]
    o2R, l2R = offs[uid2R], base_lens[uid2R]
    # left far part: s2[len2-(k-1)-ex : len2-(k-1)] when the stored
    # orientation already ends at (fn, 1-fo); else the reverse complement
    # of s2[(k-1) : (k-1)+ex]
    srcL = torch.where(sameL, o2L + l2L - (k - 1) - exL,
                       o2L + (k - 1) + exL - 1)
    # right far part: the reverse complement of s2[len2-(k-1)-ex :
    # len2-(k-1)] when the stored orientation ends at the junction; else
    # s2[(k-1) : (k-1)+ex]
    srcR = torch.where(sameR, o2R + l2R - k, o2R + (k - 1))
    zero = torch.zeros_like(offs)
    gather = torch.full_like(offs, -1)
    fwd = torch.zeros_like(sameL)
    plen = torch.stack([exL, hasL.to(torch.int64), base_lens,
                        hasR.to(torch.int64), exR], dim=1)
    psrc = torch.stack([srcL, zero, offs, zero, srcR], dim=1)
    prc = torch.stack([~sameL, fwd, fwd, fwd, sameR], dim=1)
    pconst = torch.stack([gather, jbL, gather, jbR, gather], dim=1)
    return lay_out_sequences(flat, plen, psrc, prc, pconst, next_k)


def save_contig_next_k(dbg: DBG, next_k: int, occurrence_ratio: float) -> KmerTable:
    """Contig-derived next-k occurrence table (graph.h:1655-1771): all
    next_k-mers of the extended unitig sequences, occurrence =
    u16(cov * ratio + 0.5), max-merged across unitigs. Nothing of genome
    size leaves the device."""
    with LOG.stage("    unitig sequences"):
        lab = dbg.label_unitigs_device()
        lay = extended_unitig_layout(dbg, next_k) if lab.num_u else None
        LOG.count("sequences", lab.num_u)
        LOG.count("bases", lay.total if lay else 0)
    # numpy's uint32 * float -> float64 -> uint32 truncation
    occs = (lab.ucov.to(torch.float64) * occurrence_ratio + 0.5).to(
        torch.int64).clamp(max=cnt.MAX_OCCURRENCE)
    with LOG.stage("    kmerize"):
        return kmerize_layout(lay, occs, next_k, dbg.device)


def edge_kmer_keys(dbg: DBG, next_k: int):
    """K-mers within diff = next_k - k of unitig ends (saveEdgeKmer,
    graph.h:1877-1939): a sorted subset of the node table + its length."""
    diff = next_k - dbg.k
    lab = dbg.label_unitigs_device()
    if lab.num_u == 0:
        return dbg.keys[:0], 0
    sel = lab.uid >= 0
    ulen_of = torch.where(sel, lab.ulen[lab.uid.clamp(0, lab.num_u - 1)], 0)
    edge = sel & ((lab.upos < diff) | (lab.upos >= ulen_of - diff))
    return cnt.compact_mask(dbg.keys, edge)


def filter_reads_by_edge_kmers(reads: StagedReads, edge_table,
                               k: int) -> StagedReads:
    """pickupReadMatchedEdgeKmer (counter.h:870-910): keep reads holding at
    least one edge k-mer."""
    table, n_edge = edge_table
    if n_edge == 0 or reads.num_reads == 0:
        return reads.select(torch.zeros(reads.num_reads, dtype=torch.bool,
                                        device=reads.device))
    keys, _n_valid = reads.kmers(k)
    R, P, L = keys.shape
    idx = lookup(table, keys.reshape(-1, L), n_edge)
    read_hit = (idx.reshape(R, P) >= 0).any(dim=1)
    return reads.select(read_hit)


def divide_straight_node(dbg: DBG, reads: StagedReads) -> int:
    """divideStraightNode by read mapping (graph.h:1150-1372) at node level,
    as the JAX package does it (assemble_core.py:757-799): a read that maps
    every valid window onto alive nodes covers those nodes; alive
    non-junction nodes that no such read covers are deleted. Returns the
    number of deleted nodes."""
    covered = torch.zeros(dbg.n, dtype=torch.bool, device=dbg.device)
    n_mapped = 0
    if reads.num_reads and dbg.n:
        keys, _n_valid = reads.kmers(dbg.k)
        R, P, L = keys.shape
        valid = ~is_sentinel(keys)
        idx = lookup(dbg.keys, keys.reshape(-1, L), dbg.n).reshape(R, P)
        hit = (idx >= 0) & dbg.alive[idx.clamp(0, dbg.n - 1)] & valid
        # a fully-mapping read: every valid window hits (mapRead breaks the
        # whole read on any miss, graph.h:1275-1305)
        read_ok = (hit | ~valid).all(dim=1) & valid.any(dim=1)
        covered[idx[read_ok[:, None] & hit]] = True
        n_mapped = int(read_ok.sum())
    kill = dbg.alive & ~covered & ~dbg.topo[4]
    n_kill = int(kill.sum())
    if n_kill:
        dbg.delete_nodes(kill)
    LOG.counter("TOTAL_MAPPED_READS", n_mapped)
    LOG.counter("NUM_DELETE_NODE(reads are unmapped)", n_kill)
    return n_kill


def count_considering_previous(contig_table: KmerTable,
                               reads: StagedReads) -> tuple[KmerTable, np.ndarray]:
    """makeKmerReadDistributionConsideringPreviousGraph (counter.h:663-750):
    contig-derived k-mers keep their coverage-based occurrence; read k-mers
    NOT in the contig table are counted normally; the result is the union.
    With several ranks the read count is the global table (count_reads)."""
    k = contig_table.k
    with LOG.stage("    recount: count reads"):
        read_table, _h = count_reads(reads, k)
        rk, rc = read_table.keys, read_table.counts
    with LOG.stage("    recount: merge"):
        ck, cc = contig_table.keys, contig_table.counts
        if len(read_table) and len(contig_table):
            new = lookup(ck, rk) < 0
            rk, rc = rk[new], rc[new]
        uk, uc, _un = cnt.merge_counts(ck, cc, rk, rc)
        uc = uc.clamp(max=cnt.MAX_OCCURRENCE)
        hist = cnt.histogram_host(cnt.occurrence_histogram(uc))
    return KmerTable(k, uk, uc), hist


def get_left_minimal(dist: np.ndarray) -> int:
    """getLeftMinimal (graph.h): walk right from the first nonzero entry
    until the value stops strictly decreasing."""
    size = len(dist)
    if size == 0:
        return 0
    i = 0
    while i < size and dist[i] == 0:
        i += 1
    if i >= size:
        return 1
    pre = dist[i]
    i += 1
    while i < size:
        if dist[i] >= pre:
            break
        pre = dist[i]
        i += 1
    return i - 1 if i < size else 1


def left_minimal_coverage(dbg: DBG) -> int:
    """getLeftMinimalCoverage (graph.h:1982-1993)."""
    u = dbg.label_unitigs()
    dist = np.zeros(0x10000, dtype=np.int64)
    np.add.at(dist, np.minimum(u.ucov, 0xFFFF - 1), u.ulen)
    return get_left_minimal(dist)


def build_dbg_from_table(table: KmerTable, cutoff: int) -> DBG:
    """loadKmer (counter.h:600-640): keep occurrence >= cutoff, build graph."""
    keys, counts, n = cnt.filter_by_count(table.keys, table.counts,
                                          len(table), cutoff)
    return DBG(table.k, keys, counts, n)


# ---------------------------------------------------------------------------
# full pipeline
# ---------------------------------------------------------------------------

@dataclass
class AssembleOptions:
    """assemble defaults (assemble.cpp:55-70)."""

    k: int = 32
    max_k_ratio: float = 0.5
    step: int = 10
    min_coverage: int = 1
    manual_cutoff: int = 0
    log_p_split: float = 10.0
    bubble_threshold: float = 0.0
    branch_threshold: float = 0.5
    fixed_average_coverage: float = 0.0
    repeat_mode: bool = False
    kmer_occ_only: bool = False
    memory_gb: float = 0.0
    coverage_cutoff_factor: float = 0.0
    divide_straight: bool = False  # divideStraightNode pass (disabled in
    # the reference binary, assemble.cpp:396,528)

    @property
    def min_log_p_join(self) -> float:
        return math.log(1.0 - 10.0 ** (-self.log_p_split))


@dataclass
class AssembleResult:
    contigs: list[np.ndarray]
    contig_covs: list[float]
    junctions: list[np.ndarray]
    junction_covs: list[float]
    bubbles: list
    average_length: float
    max_k: int
    kmer_table: KmerTable | None = None
    hist0: np.ndarray | None = None
    k0: int = 0


def _contigs_of(dbg: DBG, ratio: float):
    """A graph's unitig records: (sequences, covs), each cov the unitig's
    times `ratio`."""
    u = dbg.label_unitigs()
    flat, offs, lens = dbg.unitig_sequences_flat()
    return ([flat[o: o + n] for o, n in zip(offs, lens)],
            [float(c) * ratio for c in u.ucov])


def graph_records(dbg: DBG, ratio: float):
    """A graph's output records: (contig sequences, contig covs, junction
    k-mer codes, junction covs), each cov the unitig's or the junction
    k-mer's times `ratio` (assemble's contigs at its coverage ratio, the
    merge command's at 1)."""
    contigs, covs = _contigs_of(dbg, ratio)
    ji, jc = dbg.junction_info()
    j_codes = (kmer_to_codes(dbg.keys[torch.from_numpy(ji).to(dbg.device)],
                             dbg.k).cpu().numpy()
               if len(ji) else np.zeros((0, dbg.k), np.uint8))
    return contigs, covs, list(j_codes), [float(c) * ratio for c in jc]


def assemble(batches: list[ReadBatch], opts: AssembleOptions,
             device) -> AssembleResult:
    total_bases = sum(b.total_bases for b in batches)
    total_reads = sum(b.num_reads for b in batches)
    if mh.process_count() > 1:
        # each rank holds only its ingest slice; the average read length
        # fixes the k schedule, so it comes from the global totals or the
        # ranks diverge on their collectives
        tb, tr = mh.psum_histogram(np.asarray([total_bases, total_reads],
                                              np.int64))
        total_bases, total_reads = int(tb), int(tr)
    average_length = total_bases / max(total_reads, 1)

    # ---- initial k counting (initialKmerAssemble, assemble.cpp:303-386)
    k0 = opts.k
    # -m budget: the same arithmetic as the JAX package, so both take the
    # same (partitioned or single-pass) branch; with several ranks each
    # decides from its own windows
    W0 = num_words(k0)
    windows = sum(b.num_reads * max(b.codes.shape[1] - k0 + 1, 0)
                  for b in batches)
    need_gb = windows * (4 * W0 + 4) * 3 / (1 << 30)
    n_parts = 1
    while opts.memory_gb and need_gb / n_parts > opts.memory_gb and n_parts < 64:
        n_parts *= 2
    with LOG.stage("staging reads"):
        reads = stage_reads(batches, device)
    with LOG.stage(f"K = {k0}, saving kmers from reads"):
        if n_parts > 1:
            LOG.counter("NUM_COUNT_PARTITIONS", n_parts)
            keys0, counts0 = cnt.count_reads_partitioned(reads, k0, n_parts)
            counts0 = counts0.clamp(max=cnt.MAX_OCCURRENCE)
            n0 = int(keys0.shape[0])
            hist = cnt.histogram_host(cnt.occurrence_histogram(counts0))
        else:
            keys0, counts0, n0, hist = count_reads_device(reads, k0)
    shard = None
    if mh.process_count() > 1:
        # key-range sharded merge: this rank keeps ONLY its slice of the
        # raw table, which is dominated by error singletons and never
        # replicates; the global histogram is the sum of the slices'. Only
        # the cutoff-filtered slices are gathered below, for the graph.
        shard = mh.global_count_merge_sharded(
            *_host_table(keys0, counts0, k0), k=k0)
        del keys0, counts0
        hist = _shard_histogram(shard[1])
    hist0 = hist

    cutoff0 = cnt.coverage_cutoff(hist, manual=opts.manual_cutoff,
                                  repeat_mode=opts.repeat_mode)
    average_coverage = cnt.distribution_average(hist, cutoff0, cnt.MAX_OCCURRENCE)
    # coverageCutoffFactor raises the cutoff in the -repeat passes
    # (assemble.cpp:148-158, 324-325)
    if average_coverage * opts.coverage_cutoff_factor > cutoff0:
        cutoff0 = int(average_coverage * opts.coverage_cutoff_factor)
    average_coverage = cnt.distribution_average(hist, cutoff0, cnt.MAX_OCCURRENCE)
    if opts.fixed_average_coverage:
        average_coverage = opts.fixed_average_coverage
    LOG.counter("AVE_READ_LEN", average_length)
    # k-mer coverage -> read coverage (assemble.cpp:332)
    average_coverage = average_coverage * average_length / (average_length - k0 + 1.0)

    ks, cutoffs = extend_kmer_schedule(
        opts.min_log_p_join, average_coverage, average_length,
        opts.min_coverage, k0, cutoff0, opts.step, opts.max_k_ratio)

    if opts.kmer_occ_only:
        if shard is not None:
            table = _gather_table(k0, *shard, device)
        else:
            table = KmerTable(k0, keys0,
                              counts0.clamp(max=cnt.MAX_OCCURRENCE))
        return AssembleResult([], [], [], [], [], average_length, k0,
                              kmer_table=table, hist0=hist0, k0=k0)

    with LOG.stage(f"K = {k0}, graph build"):
        if shard is not None:
            # cutoff-filter each slice, THEN gather: the replicated graph
            # build sees only the filtered table
            keep = shard[1] >= cutoffs[0]
            table = _gather_table(k0, shard[0][keep], shard[1][keep], device)
            del shard
            dbg = DBG(k0, table.keys, table.counts)
        else:
            dbg = build_dbg_from_table(KmerTable(k0, keys0, counts0),
                                       cutoffs[0])
            del keys0, counts0
    clean.cut_branch_iterative(dbg, opts.branch_threshold)
    if not opts.fixed_average_coverage:
        with LOG.stage("average coverage"):
            average_coverage = clean.average_coverage_excluding_bubble(dbg)
    else:
        average_coverage = opts.fixed_average_coverage
    if opts.repeat_mode:
        kc = average_coverage
        clean.delete_erroneous_iterative(dbg, 1 << 62, 1.75 * kc + 0.5,
                                         opts.branch_threshold)
        clean.crush_bubble_iterative(dbg, float("inf"), 0.95)
    average_coverage = average_coverage * average_length / (average_length - k0 + 1.0)

    # ---- k extension loop (saveAndRedoAssemble)
    read_fp = reads
    for pos in range(1, len(ks)):
        k_new, k_prev = ks[pos], ks[pos - 1]
        with LOG.stage(f"extending k to {k_new}"):
            with LOG.stage("  edge kmers"):
                edge = edge_kmer_keys(dbg, k_new)
            with LOG.stage("  read filter"):
                read_fp = filter_reads_by_edge_kmers(read_fp, edge, k_prev)
            ratio = (average_length - k_new + 1.0) / (average_length - k_prev + 1.0)
            with LOG.stage("  save contig next-k"):
                contig_tab = save_contig_next_k(dbg, k_new, ratio)
            with LOG.stage("  recount"):
                table, _hist = count_considering_previous(contig_tab, read_fp)
            LOG.counter("COVERAGE_CUTOFF", cutoffs[pos])
            with LOG.stage("  graph build"):
                dbg = build_dbg_from_table(table, cutoffs[pos])
            with LOG.stage("  cut branch"):
                clean.cut_branch_iterative(dbg, opts.branch_threshold)
            if opts.repeat_mode:
                kc = average_coverage * (average_length - k_new + 1.0) / average_length + 0.5
                clean.delete_erroneous_iterative(dbg, 1 << 62,
                                                 1.75 * kc + 0.5,
                                                 opts.branch_threshold)
                clean.crush_bubble_iterative(dbg, float("inf"), 0.95)

    # ---- output treatment (outputAndAfterTreatment, assemble.cpp:506-622)
    k_last = ks[-1]
    with LOG.stage("left minimal coverage"):
        lmc = left_minimal_coverage(dbg)
    length_cutoff = 2 * k_last
    LOG.counter("LENGTH_CUTOFF", length_cutoff)
    LOG.counter("COVERAGE_CUTOFF", lmc)
    clean.delete_erroneous_iterative(dbg, length_cutoff, lmc,
                                     opts.branch_threshold)

    average_coverage = average_coverage * (average_length - k_last + 1.0) / average_length
    bubbles: list[clean.CrushedBubble] = []
    if opts.bubble_threshold > 0:
        LOG.counter("AVE_KMER_COV_REMOVING_BUBBLE", average_coverage)
        # -repeat overrides the bubble identity threshold (assemble.cpp:126-128)
        bub_thr = 0.95 if opts.repeat_mode else opts.bubble_threshold
        clean.crush_bubble_iterative(dbg, average_coverage, bub_thr, bubbles)

    # optional read-mapping node division (commented out in the reference
    # at assemble.cpp:396,528; opt-in via -divide_straight)
    if opts.divide_straight:
        divide_straight_node(dbg, read_fp)

    # final rebuild from the cleaned graph's own k-mers: saveContig(k, 1.0)
    with LOG.stage("final rebuild"):
        table = save_contig_next_k(dbg, k_last, 1.0)
        dbg = build_dbg_from_table(table, cutoffs[-1])

    cov_ratio = average_length / (average_length - k_last + 1.0)
    with LOG.stage("contigs"):
        contigs, contig_covs, junctions, junction_covs = graph_records(
            dbg, cov_ratio)
    return AssembleResult(contigs, contig_covs, junctions, junction_covs,
                          bubbles, average_length, k_last,
                          kmer_table=table, hist0=hist0, k0=k0)


# ---------------------------------------------------------------------------
# -repeat: three passes + contig merge (lifted from merge_cmd.py helpers)
# ---------------------------------------------------------------------------

EXCLUSION_FACTOR = 100.0  # common.h:749


def average_coverage_excluding_outlier(lengths, coverages) -> float:
    """calculateAverageCoverageExcludingOutlier (common.h:747-770) with
    minLength = median sequence length (merge_cmd.py:72)."""
    lengths = np.asarray(lengths, np.float64)
    coverages = np.asarray(coverages, np.float64)
    if len(lengths) == 0:
        return 0.0
    med = np.sort(lengths)[len(lengths) // 2]
    sel = lengths >= med
    if not sel.any():
        return 0.0
    mean0 = (coverages[sel] * lengths[sel]).sum() / lengths[sel].sum()
    ok = sel & (coverages >= mean0 / EXCLUSION_FACTOR) & (coverages <= mean0 * EXCLUSION_FACTOR)
    if not ok.any():
        return mean0
    return float((coverages[ok] * lengths[ok]).sum() / lengths[ok].sum())


def count_from_contigs(seqs, covs, k: int, min_occurrence: int,
                       device) -> KmerTable:
    """Canonical k-mers of all contigs; value = MAX over sources of
    max(coverage, min_occurrence) (merge_cmd.py:90). The concatenation
    goes to the device once and is laid out there."""
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    if not (lens >= k).any():
        return empty_table(k, device)
    flat = torch.from_numpy(
        np.concatenate([np.asarray(s, np.uint8) for s in seqs])).to(device)
    vals = torch.tensor([min(max(int(c), min_occurrence), cnt.MAX_OCCURRENCE)
                         for c in covs], dtype=torch.int64, device=device)
    plen = torch.from_numpy(lens.reshape(-1, 1)).to(device)
    psrc = torch.cumsum(plen, 0) - plen
    lay = lay_out_sequences(flat, plen, psrc, plen < 0,
                            torch.full_like(plen, -1), k)
    return kmerize_layout(lay, vals, k, device)


def assemble_repeat(batches: list[ReadBatch], opts: AssembleOptions,
                    device) -> AssembleResult:
    """`assemble -repeat` (assemble_core.py:1187): three full passes at
    coverageCutoffFactor 0, 1, 2, then a contig-level DBG merge at the
    largest k with the repeat bubble threshold 0.95; no junction records."""
    all_seqs: list[np.ndarray] = []
    all_covs: list[int] = []
    max_k = 0
    average_length = 0.0
    hist0 = None
    k0 = opts.k
    for factor in (0, 1, 2):
        LOG.info(f"REPEAT_MODE_PASS: coverageCutoffFactor = {factor}")
        r = assemble(batches, replace(opts,
                                      coverage_cutoff_factor=float(factor)),
                     device)
        all_seqs.extend(r.contigs)
        all_covs.extend(min(int(c + 0.5), 0xFFFF) for c in r.contig_covs)
        max_k = max(max_k, r.max_k)
        average_length = r.average_length
        if hist0 is None:
            hist0 = r.hist0

    lens = [len(s) for s in all_seqs]
    avg_cov = average_coverage_excluding_outlier(lens, all_covs)
    with LOG.stage(f"K = {max_k}, merging contigs (repeat mode)"):
        table = count_from_contigs(all_seqs, np.asarray(all_covs, np.float64),
                                   max_k, 1, device)
        dbg = build_dbg_from_table(table, 0)
        clean.cut_branch_iterative(dbg, opts.branch_threshold)
        clean.crush_bubble_iterative(dbg, avg_cov, 0.95)

    with LOG.stage("contigs"):
        contigs, contig_covs = _contigs_of(
            dbg, average_length / (average_length - max_k + 1.0))
    return AssembleResult(contigs, contig_covs, [], [], [],
                          average_length, max_k, kmer_table=table,
                          hist0=hist0, k0=k0)
