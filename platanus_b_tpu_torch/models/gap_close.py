"""`gap_close`: local re-assembly of scaffold gaps.

Re-design of GapClose (gapClose.h/.cpp, gapCloseDBG.h, gapCloseOLC.*):
- gap table over N runs with 150 bp flanks      <- makeGapTable (gapClose.cpp:405-483)
- gap-covering read collection via mate windows <- saveGapCoveringReads /
                                                   judgePairReadMappedNearGap (:510-596)
- per-gap dual-k DBG closer (k=20 merged into k=80, branch-cut, flank
  match with mismatch tolerance, unique-unitig rule, partial close)
                                                <- GapCloseDBG (gapCloseDBG.h:43-745)
- OLC fallback (pairwise overlap, greedy consensus extension)
                                                <- OverlapLayoutConsensus (gapCloseOLC.*)
- gap-closed sequence generation                <- generateGapClosedSeq (:1095-1180)

Gap read sets are tiny (hundreds of reads), so per-gap assembly is
host-side numpy over packed integer k-mers; the heavy stage — mapping all
pairs onto scaffolds — runs on device via models.mapper.

Simplifications (documented): the OLC overlap test counts mismatches
instead of banded edit distance (maxEditDistance=1 default makes these
nearly identical); negative-length closures trim the emitted junction
instead of re-splicing scaffold flanks.

Port copy of platanus_b_tpu/models/gap_close.py: the reference's text, its
relative imports resolving to the port's modules (hetero, log).
No other change.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..utils.log import LOG

# gapClose.cpp:36-44
HEAD_TAIL_SEQ_LEN = 150
SD_RATIO_MAPPED_GAP = 3
BRUIJN_MIN_KMER = 20
BRUIJN_MAX_KMER = 80
MIN_COVERAGE = 2
MIN_OVERLAP_FOR_CIRCLE = 100
# gapCloseDBG.h:621-625
DBG_BUBBLE_THRESHOLD = 0.1
DBG_BRANCH_THRESHOLD = 0.5
MIN_GAP_LENGTH_PARTIAL = 10

UNCLOSED, CLOSED, PART_CLOSED = 0, 1, 2


@dataclass
class Gap:
    scaffold_id: int          # 1-based
    start: int
    end: int
    head: np.ndarray          # <=150bp flank before the gap (no N)
    tail: np.ndarray          # <=150bp flank after the gap (no N)
    reads: list = field(default_factory=list)
    state: int = UNCLOSED
    closing_seq: np.ndarray | None = None
    closing_length: int = 0
    remained_gap: int = 0

    @property
    def length(self) -> int:
        return self.end - self.start


def make_gap_table(scaffolds: list[np.ndarray]) -> list[Gap]:
    """makeGapTable (gapClose.cpp:405-483)."""
    LOG.info("making hash table of gaps...")
    gaps: list[Gap] = []
    for si, s in enumerate(scaffolds):
        isn = s == 4
        if not isn.any():
            continue
        d = np.diff(isn.astype(np.int8))
        starts = [0] if isn[0] else []
        starts += list(np.nonzero(d == 1)[0] + 1)
        ends = list(np.nonzero(d == -1)[0] + 1)
        if isn[-1]:
            ends.append(len(s))
        for st, ed in zip(starts, ends):
            head = s[max(st - HEAD_TAIL_SEQ_LEN, 0): st]
            nz = np.nonzero(head == 4)[0]
            if len(nz):
                head = head[nz[-1] + 1:]
            tail = s[ed: ed + HEAD_TAIL_SEQ_LEN]
            nz = np.nonzero(tail == 4)[0]
            if len(nz):
                tail = tail[: nz[0]]
            gaps.append(Gap(si + 1, int(st), int(ed), head.copy(), tail.copy()))
    return gaps


def collect_gap_reads(gaps: list[Gap], scaffolds, ids, offs, pair_codes,
                      pair_lengths, avg_ins: int, tolerance: int) -> None:
    """judgePairReadMappedNearGap (gapClose.cpp:563-596), vectorized: when
    one end maps, its (oriented) mate is assigned to every gap whose N-run
    intersects the expected mate window. Window bounds are computed
    columnar; gap hits come from searchsorted over each scaffold's
    (disjoint, sorted) gap intervals — Python touches only the records
    that actually hit a gap."""
    ids = np.asarray(ids, dtype=np.int64)
    offs = np.asarray(offs, dtype=np.int64)
    pair_lengths = np.asarray(pair_lengths, dtype=np.int64)
    mapped = ids != 0
    if not mapped.any() or not gaps:
        return
    slen_tbl = np.array([len(s) for s in scaffolds], dtype=np.int64)
    sid = np.abs(ids)
    slen = np.where(mapped, slen_tbl[np.maximum(sid - 1, 0)], 0)
    fwd = ids > 0
    # forward-mapped: mate expected downstream (gapClose.cpp:571-580)
    f_start = np.clip(np.maximum(offs, offs + avg_ins - tolerance
                                 - pair_lengths), 0, np.maximum(slen - 1, 0))
    f_end = np.minimum(offs + avg_ins + tolerance, slen)
    # reverse-mapped: mate expected upstream (gapClose.cpp:581-589)
    r_start = np.maximum(np.minimum(offs, offs - avg_ins - tolerance), 0)
    r_end = np.minimum(offs - avg_ins + tolerance + pair_lengths, slen)
    w_start = np.where(fwd, f_start, r_start)
    w_end = np.where(fwd, f_end, r_end)

    # per-scaffold sorted gap intervals
    by_scaf: dict[int, tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
    for s_id in {g.scaffold_id for g in gaps}:
        gis = np.array([gi for gi, g in enumerate(gaps)
                        if g.scaffold_id == s_id], dtype=np.int64)
        gs = np.array([gaps[gi].start for gi in gis], dtype=np.int64)
        ge = np.array([gaps[gi].end for gi in gis], dtype=np.int64)
        order = np.argsort(gs)
        by_scaf[s_id] = (gs[order], ge[order], gis[order])

    cand = np.nonzero(mapped & (w_end > w_start))[0]
    # vector interval join per scaffold (the former per-record Python
    # searchsorted loop was ~10% of gap_close wall at 1000-gap scale)
    for s_id, (gs, ge, gis) in by_scaf.items():
        sel = cand[sid[cand] == s_id]
        if not len(sel):
            continue
        lo = np.searchsorted(ge, w_start[sel], side="right")
        hi = np.searchsorted(gs, w_end[sel], side="left")
        nhit = hi - lo
        has = nhit > 0
        sel2, lo2, n2 = sel[has], lo[has], nhit[has]
        if not len(sel2):
            continue
        # oriented mates for the hitting records, one vector pass
        rows = pair_codes[sel2]
        lens = pair_lengths[sel2]
        f2 = fwd[sel2]
        mates = []
        for r in range(len(sel2)):
            L = int(lens[r])
            mate = rows[r, :L]
            if f2[r]:
                mate = mate[::-1].copy()
                m = mate < 4
                mate[m] = 3 - mate[m]
            mates.append(mate)
        # expand records with multiple gap hits
        rep = np.repeat(np.arange(len(sel2)), n2)
        offs_in = np.arange(len(rep)) - np.repeat(
            np.concatenate([[0], np.cumsum(n2)[:-1]]), n2)
        g_hit = gis[lo2[rep] + offs_in]
        for r, gi in zip(rep, g_hit):
            gaps[gi].reads.append(mates[r])


# ---------------------------------------------------------------------------
# single-strand mini-DBG (makeBruijnGraphForGapClose, graph.h:2117-2344)
# ---------------------------------------------------------------------------

# shared read separator for the concat-and-pack counters (any value > 3
# invalidates windows crossing a read boundary)
_SEP = np.array([255], np.uint8)


def _rolling_words(cat: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """(words (Lw, W) u64, valid (Lw,)) for every window start of the
    separator-joined code array `cat`: word w covers bases
    [32w, min(32(w+1), k)), right-aligned within its span.

    Doubling pack: p[2^e][i] = window of 2^e bases at i, built with
    log2(k) shift-or passes over 1-D arrays — no (N, k) window matrix
    (the former stride-tricks + per-column shift-sum packing was the
    gap-close counting hot spot). Validity = no N/separator inside the
    window, via the next-invalid-position running minimum."""
    L = len(cat)
    Lw = L - k + 1
    W = (k + 31) // 32
    if Lw <= 0:
        return np.zeros((0, W), np.uint64), np.zeros(0, bool)
    c = np.where(cat <= 3, cat, 0).astype(np.uint64)
    pows = {1: c}
    e = 1
    while e < min(k, 32):
        half = pows[e]
        n2 = max(len(half) - e, 0)
        pows[2 * e] = (half[:n2] << np.uint64(2 * e)) | half[e: e + n2]
        e *= 2

    def pack_width(width: int, base_off: int) -> np.ndarray:
        """u64 word of `width` bases starting at cat[i + base_off]."""
        out = None
        pos = base_off
        bit = 32
        while bit:
            if width & bit:
                part = pows[bit][pos: pos + Lw] if pos + Lw <= len(pows[bit]) \
                    else np.pad(pows[bit][pos:], (0, pos + Lw - len(pows[bit])))
                out = part if out is None \
                    else (out << np.uint64(2 * bit)) | part
                pos += bit
            bit >>= 1
        return out if out is not None else np.zeros(Lw, np.uint64)

    words = np.empty((Lw, W), np.uint64)
    for w in range(W):
        width = min(32, k - 32 * w)
        words[:, w] = pack_width(width, 32 * w)
    # next invalid position at or after i
    bad = cat > 3
    nb = np.where(bad, np.arange(L), L)
    nb = np.minimum.accumulate(nb[::-1])[::-1]
    valid = nb[:Lw] >= np.arange(Lw) + k
    return words, valid


def _count_words_batch(seqs, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Unique forward-strand k-mers over a read set, one vectorized pass:
    reads are concatenated with N separators, packed with the doubling
    rolling pack, and uniqued (countKmerForGapClose counterpart,
    counter.h:1016-1056). Returns (words (N, W) u64 sorted, counts)."""
    W = (k + 31) // 32
    if not seqs:
        return np.zeros((0, W), np.uint64), np.zeros(0, np.int64)
    cat = np.concatenate([x for s in seqs for x in (s, _SEP)])
    if len(cat) < k:
        return np.zeros((0, W), np.uint64), np.zeros(0, np.int64)
    words, valid = _rolling_words(cat, k)
    words = words[valid]
    if not len(words):
        return np.zeros((0, W), np.uint64), np.zeros(0, np.int64)
    uw, starts, _ = _dedup_rows(words)
    counts = np.diff(np.append(starts, len(words)))
    return np.ascontiguousarray(uw), counts.astype(np.int64)


def _count_words_valued(seqs, vals: np.ndarray, k: int
                        ) -> tuple[np.ndarray, np.ndarray]:
    """k-mer word rows of several sequences with a PER-SEQUENCE value,
    reduced to unique rows carrying the MAX value — one pass for all
    sequences (saveLargeKmerForGapClose merge rule)."""
    W = (k + 31) // 32
    if not seqs:
        return np.zeros((0, W), np.uint64), np.zeros(0, np.int64)
    cat = np.concatenate([x for s in seqs for x in (s, _SEP)])
    src = np.repeat(np.arange(len(seqs), dtype=np.int64),
                    np.array([len(s) + 1 for s in seqs]))
    if len(cat) < k:
        return np.zeros((0, W), np.uint64), np.zeros(0, np.int64)
    win = np.lib.stride_tricks.sliding_window_view(cat, k)
    ok = (win <= 3).all(axis=1)
    win = win[ok]
    wvals = np.asarray(vals, np.int64)[src[: len(ok)][ok]]
    if not len(win):
        return np.zeros((0, W), np.uint64), np.zeros(0, np.int64)
    words = np.zeros((len(win), W), dtype=np.uint64)
    for w in range(W):
        chunk = win[:, w * 32: (w + 1) * 32].astype(np.uint64)
        shifts = np.uint64(2) * np.arange(chunk.shape[1] - 1, -1, -1,
                                          dtype=np.uint64)
        words[:, w] = (chunk << shifts).sum(axis=1)
    uw, starts, (svals,) = _dedup_rows(words, wvals)
    return np.ascontiguousarray(uw), np.maximum.reduceat(svals, starts)


def _word_widths(k: int) -> list[int]:
    W = (k + 31) // 32
    return [min(32 * (w + 1), k) - 32 * w for w in range(W)]


def _succ_words(words: np.ndarray, k: int, base: int) -> np.ndarray:
    """(v << 2 | base) within 2k bits, on the per-word representation."""
    widths = _word_widths(k)
    W = len(widths)
    out = np.empty_like(words)
    for w in range(W):
        mask = np.uint64((1 << (2 * widths[w])) - 1)
        if w + 1 < W:
            carry = words[:, w + 1] >> np.uint64(2 * (widths[w + 1] - 1))
        else:
            carry = np.uint64(base)
        out[:, w] = ((words[:, w] << np.uint64(2)) | carry) & mask
    return out


def _pred_words(words: np.ndarray, k: int, base: int) -> np.ndarray:
    """(base << 2(k-1) | v >> 2) on the per-word representation."""
    widths = _word_widths(k)
    W = len(widths)
    out = np.empty_like(words)
    for w in range(W):
        if w == 0:
            carry = np.uint64(base)
        else:
            carry = words[:, w - 1] & np.uint64(3)
        out[:, w] = (words[:, w] >> np.uint64(2)) \
            | (carry << np.uint64(2 * (widths[w] - 1)))
    return out


def _row_hash(words: np.ndarray) -> np.ndarray:
    """Vectorized 64-bit FNV-style mix of each word row (lookup key for
    the hash-sorted node table; exactness comes from row verification,
    not the hash)."""
    h = np.full(len(words), 0xCBF29CE484222325, np.uint64)
    for w in range(words.shape[1]):
        h = (h ^ words[:, w]) * np.uint64(0x100000001B3)
        h ^= h >> np.uint64(29)
    return h


def _dedup_rows(words: np.ndarray, *payloads: np.ndarray):
    """Lexsort word rows, return (unique rows, run starts -> reduced
    payload arrays via reduceat) — exact, no structured dtypes."""
    order = np.lexsort(tuple(words[:, w]
                             for w in range(words.shape[1] - 1, -1, -1)))
    sw = words[order]
    new_run = np.empty(len(sw), bool)
    new_run[0] = True
    new_run[1:] = (sw[1:] != sw[:-1]).any(axis=1)
    starts = np.flatnonzero(new_run)
    return sw[starts], starts, tuple(p[order] for p in payloads)


class MiniDBG:
    """Single-strand DBG over a tiny read set, with unitig tracing and
    iterative tip clipping.

    Array-based: k-mers live as (N, W) u64 word rows ordered by a 64-bit
    row hash; successor/predecessor resolution is one u64 searchsorted
    over the hash order plus exact row verification — replacing both the
    per-node Python-int dict walk and the slow structured-dtype
    unique/searchsorted (together they dominated gap-close wall clock)."""

    def __init__(self, k: int):
        self.k = k
        self.W = (k + 31) // 32
        self.keys = np.zeros((0, self.W), np.uint64)
        self.cov = np.zeros(0, np.int64)
        self.h = np.zeros(0, np.uint64)
        self._topo = None
        self._unitig_cache = None

    def _set_table(self, words: np.ndarray, cnt: np.ndarray):
        h = _row_hash(words)
        order = np.argsort(h, kind="stable")
        self.keys = np.ascontiguousarray(words[order])
        self.cov = cnt[order]
        self.h = h[order]
        self._topo = None
        self._unitig_cache = None

    def count(self, seqs, min_cov: int,
              extra: tuple[np.ndarray, np.ndarray] | None = None):
        words, cnt = _count_words_batch(seqs, self.k)
        if extra is not None and len(extra[0]):
            # extra (contig-derived) occurrences merge by MAX against the
            # read counts (saveLargeKmerForGapClose semantics)
            ewords, evals = extra
            allw = np.concatenate([words, ewords], axis=0)
            vals = np.concatenate([cnt, np.zeros(len(ewords), np.int64)])
            emax = np.concatenate([np.zeros(len(words), np.int64),
                                   np.asarray(evals, np.int64)])
            uw, starts, (svals, semax) = _dedup_rows(allw, vals, emax)
            words = uw
            cnt = np.maximum(np.add.reduceat(svals, starts),
                             np.maximum.reduceat(semax, starts))
        keep = cnt >= min_cov
        self._set_table(np.ascontiguousarray(words[keep]), cnt[keep])

    def _find_rows(self, cand: np.ndarray) -> np.ndarray:
        """Index of each candidate row in the table (-1 = absent):
        hash searchsorted + exact row check, probing forward through
        equal-hash runs."""
        n = len(self.keys)
        m = len(cand)
        res = np.full(m, -1, np.int64)
        if n == 0 or m == 0:
            return res
        ch = _row_hash(cand)
        idx0 = np.searchsorted(self.h, ch)
        pending = np.arange(m)
        off = 0
        while len(pending):
            idx = idx0[pending] + off
            ic = np.clip(idx, 0, n - 1)
            same_h = (idx < n) & (self.h[ic] == ch[pending])
            eq = same_h & (self.keys[ic] == cand[pending]).all(axis=1)
            res[pending[eq]] = ic[eq]
            pending = pending[same_h & ~eq]
            idx0 = idx0  # probe next slot of the equal-hash run
            off += 1
        return res

    # -- topology -----------------------------------------------------
    def _topology(self):
        """succ_idx/pred_idx (N, 4) int64 (-1 = absent), degrees."""
        if self._topo is not None:
            return self._topo
        n = len(self.keys)
        # all 8 neighbor candidates (4 succ + 4 pred bases) resolve in ONE
        # lookup over the concatenated candidate rows
        cands = [_succ_words(self.keys, self.k, b) for b in range(4)] + \
                [_pred_words(self.keys, self.k, b) for b in range(4)]
        res = self._find_rows(np.concatenate(cands, axis=0)).reshape(8, n).T
        succ = np.ascontiguousarray(res[:, :4])
        pred = np.ascontiguousarray(res[:, 4:])
        outdeg = (succ >= 0).sum(axis=1)
        indeg = (pred >= 0).sum(axis=1)
        self._topo = (succ, pred, outdeg, indeg)
        return self._topo

    def _chain_arrays(self):
        """Chain decomposition as flat arrays: (order, starts, chain_lens,
        covsum, uid) with nodes of chain c at order[starts[c]:
        starts[c]+chain_lens[c]] and uid = chain id per node. Cached per
        graph state; no sequence decode (cut_branch_iterative consumes
        this every round — the former per-chain Python loop with set()
        membership was the closer loop's second-largest cost)."""
        if getattr(self, "_chain_cache", None) is not None:
            return self._chain_cache
        n = len(self.keys)
        succ, pred, outdeg, indeg = self._topology()
        uniq_succ = succ.max(axis=1)          # valid when outdeg == 1
        # chain link v -> nxt[v] iff outdeg(v)==1 and indeg(nxt)==1
        nxt = np.where(outdeg == 1, uniq_succ, -1)
        tgt = np.clip(nxt, 0, n - 1)
        nxt = np.where((nxt >= 0) & (indeg[tgt] == 1), nxt, -1)
        prv = np.full(n, -1, np.int64)
        has = nxt >= 0
        prv[nxt[has]] = np.flatnonzero(has)
        # numpy pointer doubling to heads/ranks; leftover live pointers
        # after log2(n) rounds are cycles, cut at their min-index node
        idx = np.arange(n, dtype=np.int64)
        ptr = prv.copy()
        rank = (ptr >= 0).astype(np.int64)
        anchor = np.where(ptr >= 0, ptr, idx)
        max_it = max(int(np.ceil(np.log2(n + 2))) + 1, 2)
        for _ in range(max_it):
            live = np.flatnonzero(ptr >= 0)
            if not len(live):
                break
            p = ptr[live]
            rank[live] += rank[p]
            anchor[live] = anchor[p]
            ptr[live] = ptr[p]
        cyc = np.flatnonzero(ptr >= 0)
        if len(cyc):
            seen = np.zeros(n, bool)
            for c0 in cyc:
                if seen[c0]:
                    continue
                members = [int(c0)]
                seen[c0] = True
                v = int(prv[c0])
                while v != c0:
                    members.append(v)
                    seen[v] = True
                    v = int(prv[v])
                cut = min(members)  # canonical cycle cut
                src = next(m for m in members if nxt[m] == cut)
                prv[cut] = -1
                nxt[src] = -1
            # re-rank after the cuts (rare path)
            ptr = prv.copy()
            rank = (ptr >= 0).astype(np.int64)
            anchor = np.where(ptr >= 0, ptr, idx)
            for _ in range(max_it):
                live = np.flatnonzero(ptr >= 0)
                if not len(live):
                    break
                p = ptr[live]
                rank[live] += rank[p]
                anchor[live] = anchor[p]
                ptr[live] = ptr[p]
        # group nodes into chains ordered by (head, rank)
        order = np.lexsort((rank, anchor))
        heads_sorted = anchor[order]
        new_chain = np.empty(n, bool)
        new_chain[0] = True
        new_chain[1:] = heads_sorted[1:] != heads_sorted[:-1]
        starts = np.flatnonzero(new_chain)
        chain_lens = np.diff(np.append(starts, n))
        uid = np.empty(n, np.int64)
        uid[order] = np.repeat(np.arange(len(starts)), chain_lens)
        covsum = np.add.reduceat(self.cov[order].astype(np.float64), starts)
        self._chain_cache = (order, starts, chain_lens, covsum, uid)
        return self._chain_cache

    def unitigs(self, with_chains: bool = False):
        """Maximal chains: (base-code seq, kmer count, mean coverage)
        (+ index chains when with_chains). Cached per graph state."""
        if self._topo is not None and getattr(self, "_unitig_cache", None):
            res = self._unitig_cache
            if with_chains:
                return res
            return [(s_, n_, c_) for s_, n_, c_ in
                    ((r[0], r[1], r[2]) for r in res)]
        n = len(self.keys)
        if n == 0:
            return []
        order, starts, chain_lens, covsum, _uid = self._chain_arrays()
        chains = np.split(order, starts[1:])
        widths = _word_widths(self.k)
        # vectorized decode of every chain's first k-mer: (C, k) bases
        firsts = self.keys[order[starts]]
        cols = []
        for w in range(self.W):
            ww = int(widths[w])
            sh = np.uint64(2) * np.arange(ww - 1, -1, -1, dtype=np.uint64)
            cols.append(((firsts[:, w:w + 1] >> sh[None, :])
                         & np.uint64(3)).astype(np.uint8))
        first_bases = np.concatenate(cols, axis=1)
        last_base_all = (self.keys[order, self.W - 1]
                         & np.uint64(3)).astype(np.uint8)
        res = []
        for ci, chain in enumerate(chains):
            L = int(chain_lens[ci])
            seq = np.empty(L + self.k - 1, dtype=np.uint8)
            seq[: self.k] = first_bases[ci]
            # subsequent k-mers append their last base (low bits of the
            # final word)
            seq[self.k:] = last_base_all[starts[ci] + 1: starts[ci] + L]
            res.append((seq, L, float(covsum[ci] / L), chain))
        self._unitig_cache = res
        if with_chains:
            return res
        return [(s_, n_, c_) for s_, n_, c_, _ch in res]

    def cut_branch_iterative(self, branch_threshold=DBG_BRANCH_THRESHOLD):
        """Tip clipping to fixed point (cutBranch semantics: short chains
        attached on exactly one side, coverage <= threshold * max
        sibling) — fully vectorized over the chain arrays."""
        while True:
            n = len(self.keys)
            if n == 0:
                break
            succ, pred, _od, _id = self._topology()
            order, starts, clens, covsum, uid = self._chain_arrays()
            C = len(starts)
            if C == 0:
                break
            heads = order[starts]
            tails = order[starts + clens - 1]
            covm = covsum / clens
            cidx = np.arange(C)
            hp = pred[heads]                                   # (C, 4)
            hp_ok = (hp >= 0) & (uid[np.clip(hp, 0, n - 1)]
                                 != cidx[:, None])
            ts = succ[tails]
            ts_ok = (ts >= 0) & (uid[np.clip(ts, 0, n - 1)]
                                 != cidx[:, None])
            has_h = hp_ok.any(axis=1)
            has_t = ts_ok.any(axis=1)
            tip = (clens <= self.k) & (has_h ^ has_t)
            first_h = hp[cidx, np.argmax(hp_ok, axis=1)]
            first_t = ts[cidx, np.argmax(ts_ok, axis=1)]
            junc = np.clip(np.where(has_h, first_h, first_t), 0, n - 1)
            sibs = np.where(has_h[:, None], succ[junc], pred[junc])
            sib_ok = (sibs >= 0) & (uid[np.clip(sibs, 0, n - 1)]
                                    != cidx[:, None])
            sib_cov = np.where(sib_ok,
                               self.cov[np.clip(sibs, 0, n - 1)],
                               0).max(axis=1)
            kill_chain = tip & (covm <= sib_cov * branch_threshold)
            if not kill_chain.any():
                break
            keep = ~kill_chain[uid]
            self.keys = np.ascontiguousarray(self.keys[keep])
            self.cov = self.cov[keep]
            # ALL caches die together: stale chain/unitig indices point
            # into the pre-kill arrays
            self._topo = None
            self._unitig_cache = None
            self._chain_cache = None


# ---------------------------------------------------------------------------
# flank matching (calcMissmatch{Left,Right}EdgeSeq, gapCloseDBG.h:598-680)
# ---------------------------------------------------------------------------

def _match_candidates(neq: np.ndarray, lengths: np.ndarray, max_ov: np.ndarray,
                      min_overlap: int, max_miss_rate: float):
    """Shared tail of the matchers: neq (L, J) mismatch matrix (row per
    candidate length, anchored at offset j=0), pick the reference's best:
    smallest final miss rate, first (largest length) on ties, subject to
    the two tolerance gates (calcMissmatch*, gapCloseDBG.h:598-680)."""
    L = len(lengths)
    if L == 0:
        return 0, 1.0
    # only two prefix sums per row are consumed — the probe-window count
    # and the full-overlap count — so sum those slices directly instead
    # of materializing the (L, J) running cumsum (the former cumsum was
    # ~1/3 of dbg-closer wall at 1000-gap scale)
    probe_w = int(np.minimum(min_overlap, max_ov).max())
    probe_sum = neq[:, :probe_w].sum(axis=1, dtype=np.int64)
    full = (max_ov == neq.shape[1])
    final = np.empty(L, np.int64)
    final[full] = neq[full].sum(axis=1, dtype=np.int64)
    part = np.flatnonzero(~full)
    if len(part):
        jj = np.arange(neq.shape[1])
        in_ov = jj[None, :] < max_ov[part, None]
        final[part] = (neq[part] & in_ov).sum(axis=1, dtype=np.int64)
        # probe windows shorter than probe_w (max_ov < min_overlap rows)
        short = part[max_ov[part] < probe_w]
        for r in short:
            probe_sum[r] = int(neq[r, : max_ov[r]].sum())
    tol1 = (lengths * max_miss_rate + 0.5).astype(np.int64)
    tol2 = (max_ov * max_miss_rate + 0.5).astype(np.int64)
    ok = (probe_sum <= tol1) & (final <= tol2)
    if not ok.any():
        return 0, 1.0
    rate = np.where(ok, final / max_ov, np.inf)
    best = int(np.argmin(rate))   # lengths are in DESCENDING order
    return int(lengths[best]), float(rate[best])


def _match_left(head: np.ndarray, u: np.ndarray, min_overlap: int,
                max_miss_rate: float):
    """Best 'length' such that u[:length]'s tail aligns to head's tail —
    one broadcasted mismatch matrix instead of a cumsum per candidate."""
    hs = len(head)
    n = len(u)
    if n < min_overlap:
        return 0, 1.0
    lengths = np.arange(n, min_overlap - 1, -1)
    max_ov = np.minimum(lengths, hs)
    jmax = int(max_ov.max())
    # cell (row, j): u[length-1-j] vs head[hs-1-j]
    uidx = lengths[:, None] - 1 - np.arange(jmax)[None, :]
    neq = u[np.clip(uidx, 0, n - 1)] != head[hs - 1 - np.arange(jmax)][None, :]
    return _match_candidates(neq, lengths, max_ov, min_overlap,
                             max_miss_rate)


def _match_right(tail: np.ndarray, u: np.ndarray, min_overlap: int,
                 max_miss_rate: float):
    """Best 'length' such that u's tail-segment matches tail's head."""
    ts = len(tail)
    n = len(u)
    if n < min_overlap:
        return 0, 1.0
    lengths = np.arange(n, min_overlap - 1, -1)
    max_ov = np.minimum(lengths, ts)
    jmax = int(max_ov.max())
    # cell (row, j): u[n-length+j] vs tail[j]
    uidx = n - lengths[:, None] + np.arange(jmax)[None, :]
    neq = u[np.clip(uidx, 0, n - 1)] != tail[np.arange(jmax)][None, :]
    return _match_candidates(neq, lengths, max_ov, min_overlap,
                             max_miss_rate)


def dbg_close_gap(gap: Gap, min_k=BRUIJN_MIN_KMER, max_k=BRUIJN_MAX_KMER,
                  min_cov=MIN_COVERAGE, min_overlap=32, max_miss_rate=0.01,
                  allow_partial=True) -> bool:
    """GapCloseDBG.gapAssemble + closedGap(+Partial)."""
    if len(gap.head) < min_overlap or len(gap.tail) < min_overlap:
        return False
    # merge: low-k unitigs re-k-merized into the high-k table
    # (mergeGraph + saveLargeKmerForGapClose, gapCloseDBG.h:166-258)
    units = _assemble_gap_reads(gap, min_k, max_k, min_cov)

    # full closure: exactly one unitig must match BOTH flanks
    best = None
    for u in units:
        lo, lr = _match_left(gap.head, u, min_overlap, max_miss_rate)
        if lo == 0:
            continue
        ro, rr = _match_right(gap.tail, u, min_overlap, max_miss_rate)
        if ro == 0:
            continue
        if best is not None:
            best = None
            break  # ambiguous (gapCloseDBG.h:503-504)
        best = (u, lo, ro)
    if best is not None:
        u, lo, ro = best
        fill_len = len(u) - lo - ro
        if fill_len > 0:
            gap.closing_seq = u[lo: lo + fill_len].copy()
            gap.closing_length = fill_len
        elif fill_len <= 0:
            ov = -fill_len
            if ov > len(gap.head) or ov > len(gap.tail):
                return False
            if not np.array_equal(gap.head[len(gap.head) - ov:],
                                  gap.tail[:ov]):
                return False
            # flanks themselves overlap: negative closure trims the tail
            gap.closing_seq = np.zeros(0, np.uint8)
            gap.closing_length = -(ov)
        gap.state = CLOSED
        gap.remained_gap = 0
        return True

    if not allow_partial:
        return False
    # partial closure: best left-matching unitig + best right-matching one
    best_l = best_r = None
    bl_rate = br_rate = 1.0
    bl_len = br_len = 0
    for u in units:
        lo, lr = _match_left(gap.head, u, min_overlap, max_miss_rate)
        if lo > 0 and lr < bl_rate:
            best_l, bl_len, bl_rate = u, lo, lr
            continue
        ro, rr = _match_right(gap.tail, u, min_overlap, max_miss_rate)
        if ro > 0 and rr < br_rate:
            best_r, br_len, br_rate = u, ro, rr
    if best_l is None and best_r is None:
        return False
    left_fill = best_l[bl_len:] if best_l is not None else np.zeros(0, np.uint8)
    right_fill = (best_r[: len(best_r) - br_len]
                  if best_r is not None else np.zeros(0, np.uint8))
    fill = len(left_fill) + len(right_fill)
    gap_len = max(gap.length - fill, MIN_GAP_LENGTH_PARTIAL)
    gap.closing_seq = np.concatenate([
        left_fill, np.full(gap_len, 4, np.uint8), right_fill])
    gap.closing_length = len(gap.closing_seq)
    gap.remained_gap = gap_len
    gap.state = PART_CLOSED
    return True


def _assemble_gap_reads(gap: Gap, min_k=BRUIJN_MIN_KMER, max_k=BRUIJN_MAX_KMER,
                        min_cov=MIN_COVERAGE):
    """Dual-k assembly of a gap's read set; returns high-k unitigs.

    Cached per (read count, params): the command layer retries a failed
    full closure as a partial closure with the identical read set
    (gapClose.cpp:699-762 does the same dual call)."""
    ck = (len(gap.reads), min_k, max_k, min_cov)
    cached = getattr(gap, "_units_cache", None)
    if cached is not None and cached[0] == ck:
        return cached[1]
    units = _assemble_gap_reads_impl(gap, min_k, max_k, min_cov)
    gap._units_cache = (ck, units)
    return units


def _assemble_gap_reads_impl(gap: Gap, min_k=BRUIJN_MIN_KMER,
                             max_k=BRUIJN_MAX_KMER, min_cov=MIN_COVERAGE):
    seqs = [gap.head, gap.tail] + gap.reads
    low = MiniDBG(min_k)
    low.count(seqs, min_cov)
    low.cut_branch_iterative()
    units = low.unitigs()
    useqs = [u[0] for u in units]
    uvals = np.array([max(int(c + 0.5), min_cov) for _s, _n, c in units],
                     np.int64)
    extra = _count_words_valued(useqs, uvals, max_k)
    high = MiniDBG(max_k)
    high.count(seqs, min_cov, extra=extra)
    high.cut_branch_iterative()
    return [u for u, _nk, _c in high.unitigs()]


def dbg_extend_edge(gap: Gap, scaffold_len: int, min_overlap=32,
                    max_miss_rate=0.01) -> bool:
    """extendEdgeEntity (gapCloseDBG.h:689-741): extend a scaffold edge gap
    with the minimum-miss-rate unitig overlapping the single flank."""
    units = _assemble_gap_reads(gap)
    best = None
    best_rate = 1.0
    best_len = 0
    at_start = gap.start == 0
    for u in units:
        if not at_start:
            ln, rate = _match_left(gap.head, u, min_overlap, max_miss_rate)
        else:
            ln, rate = _match_right(gap.tail, u, min_overlap, max_miss_rate)
        if ln > 0 and rate < best_rate:
            best, best_rate, best_len = u, rate, ln
    if best is None or best_len == 0:
        return False
    ext = len(best) - best_len
    if ext <= 0:
        return False
    if not at_start:
        gap.closing_seq = best[best_len:].copy()
    else:
        gap.closing_seq = best[:ext].copy()
    gap.closing_length = len(gap.closing_seq)
    gap.state = CLOSED
    return True


def local_assemble_extra_contigs(gaps: list[Gap]) -> list[np.ndarray]:
    """localAssemble (gapClose.cpp:1325-1361): assemble the read pools of
    still-unclosed gaps; all resulting unitigs become _extraContig.fa."""
    out = []
    for g in gaps:
        if g.state != UNCLOSED or not g.reads:
            continue
        out.extend(_assemble_gap_reads(g))
    return out


# ---------------------------------------------------------------------------
# OLC fallback (gapCloseOLC.cpp)
# ---------------------------------------------------------------------------

def _best_overlap(a: np.ndarray, b: np.ndarray, min_overlap: int,
                  max_edit: int) -> int:
    """Longest suffix(a)/prefix(b) overlap within <= max_edit edits
    (banded edit distance, pairwiseAlignmentOLC gapCloseOLC.cpp:147-318 —
    indels allowed, not just mismatches)."""
    top = min(len(a), len(b))
    if top < min_overlap:
        return 0
    # equal-length strings: every indel must pair with a compensating
    # indel (cost 2), so edit <= 1 is EXACTLY hamming <= 1 — the banded
    # DP fallback is provably redundant for max_edit <= 1, and it was
    # ~70% of gap_close wall clock (one DP per failing (read, ov) pair)
    if max_edit >= 2:
        from .hetero import align_scaffold
        for ov in range(top, min_overlap - 1, -1):
            suf = a[len(a) - ov:]
            pre = b[:ov]
            if int((suf != pre).sum()) <= max_edit:
                return ov
            if align_scaffold(suf, pre, max_edit) <= max_edit:
                return ov
        return 0
    # vectorized: mismatches of every candidate overlap at once.
    # V[s, j] = A[s + j] vs b[j] with s = top - ov; M[s] = mismatches of
    # the length-(top-s) overlap = running row sum up to j < top - s.
    A = a[len(a) - top:]
    A_ext = np.concatenate([A, np.full(top, 0xFF, a.dtype)])
    V = np.lib.stride_tricks.sliding_window_view(A_ext, top)[:top]
    neq = V != b[:top][None, :]
    C = np.cumsum(neq, axis=1)
    s_idx = np.arange(top)
    ov_of = top - s_idx
    M = C[s_idx, np.maximum(ov_of - 1, 0)]
    ok = (M <= max_edit) & (ov_of >= min_overlap)
    hits = np.flatnonzero(ok)
    return int(ov_of[hits[0]]) if len(hits) else 0


def _best_overlap_many(layout: np.ndarray, reads: list, min_overlap: int,
                       max_edit: int) -> np.ndarray:
    """_best_overlap for MANY reads against one layout in one pass (only
    the hamming regime, max_edit <= 1 — the default; callers with
    max_edit >= 2 fall back to per-read calls). One descending sweep
    over overlap lengths tests every still-pending read's prefix against
    the layout suffix as a matrix compare — the former per-(read, round)
    calls were the OLC closer's hot loop (75k calls / 8 s at 1000-gap
    scale, gapCloseOLC.cpp:368-553's inner overlap scans)."""
    n = len(reads)
    res = np.zeros(n, np.int64)
    if n == 0 or max_edit >= 2:
        for i, r in enumerate(reads):
            res[i] = _best_overlap(layout, r, min_overlap, max_edit)
        return res
    lens = np.array([len(r) for r in reads], np.int64)
    top = np.minimum(len(layout), lens)
    maxT = int(top.max()) if n else 0
    if maxT < min_overlap:
        return res
    B = np.full((n, maxT), 0xFF, np.uint8)
    for i, r in enumerate(reads):
        m = min(len(r), maxT)
        B[i, :m] = r[:m]
    lay = np.asarray(layout)
    pending = np.ones(n, bool)
    for ov in range(maxT, min_overlap - 1, -1):
        rows = np.flatnonzero(pending & (top >= ov))
        if not len(rows):
            continue
        suf = lay[len(lay) - ov:]
        mism = (B[rows, :ov] != suf[None, :]).sum(axis=1)
        hit = mism <= max_edit
        if hit.any():
            res[rows[hit]] = ov
            pending[rows[hit]] = False
    return res


def olc_close_gap(gap: Gap, min_overlap=32, max_edit=1,
                  min_consensus=0.66) -> bool:
    """Greedy layout extension from the head flank with per-column consensus
    voting (greedyExtension/consensusBase, gapCloseOLC.cpp:368-553)."""
    reads = [r for r in gap.reads if len(r) >= min_overlap]
    if not reads or len(gap.head) < min_overlap or len(gap.tail) < min_overlap:
        return False
    layout = gap.head.copy()
    used = np.zeros(len(reads), dtype=bool)
    # distance-consistency state (checkDistance/selectProperLink,
    # gapCloseOLC.cpp:555-637): a read keeps one layout position; votes
    # from contradictory placements are rejected
    placement: dict[int, int] = {}
    max_total = gap.length + 2 * HEAD_TAIL_SEQ_LEN + sum(len(r) for r in reads)
    while len(layout) < max_total:
        # closed? tail flank overlaps layout end
        ov_t = _best_overlap(layout, gap.tail, min_overlap, max_edit)
        if ov_t > 0:
            fill = layout[len(gap.head): len(layout) - ov_t]
            gap.closing_seq = fill.copy()
            gap.closing_length = len(fill)
            gap.state = CLOSED
            gap.remained_gap = 0
            return True
        # collect candidate extensions (all pending reads' overlaps in
        # one batched sweep)
        votes: dict[int, np.ndarray] = {}
        placed = False
        ext_len = 0
        cols: list[list[int]] = []
        pend_ri = [ri for ri in range(len(reads)) if not used[ri]]
        ovs = _best_overlap_many(layout, [reads[ri] for ri in pend_ri],
                                 min_overlap, max_edit)
        ov_of = dict(zip(pend_ri, ovs))
        for ri, r in enumerate(reads):
            if used[ri]:
                continue
            ov = int(ov_of[ri])
            if ov == 0 or ov >= len(r):
                continue
            pos = len(layout) - ov
            prev_pos = placement.get(ri)
            if prev_pos is not None and abs(prev_pos - pos) > max_edit:
                continue   # contradictory placement: no vote
            placement.setdefault(ri, pos)
            ext = r[ov:]
            placed = True
            for j, b in enumerate(ext):
                while len(cols) <= j:
                    cols.append([0, 0, 0, 0, 0])
                cols[j][min(int(b), 4)] += 1
        if not placed or not cols:
            return False
        new_bases = []
        for col in cols:
            tot = sum(col)
            bmax = int(np.argmax(col))
            if tot == 0 or col[bmax] / tot < min_consensus:
                break
            new_bases.append(bmax)
        if not new_bases:
            return False
        # mark reads fully consumed by the new layout end as used
        layout = np.concatenate([layout, np.array(new_bases, np.uint8)])
        pend_ri = [ri for ri in range(len(reads)) if not used[ri]]
        ovs = _best_overlap_many(layout, [reads[ri] for ri in pend_ri],
                                 min_overlap, max_edit)
        for ri, ov in zip(pend_ri, ovs):
            if ov >= len(reads[ri]):
                used[ri] = True
    return False


# ---------------------------------------------------------------------------
# output (generateGapClosedSeq, gapClose.cpp:1095-1180)
# ---------------------------------------------------------------------------

def generate_gap_closed_seqs(scaffolds: list[np.ndarray],
                             gaps: list[Gap]) -> list[np.ndarray]:
    by_scaffold: dict[int, list[Gap]] = {}
    for g in gaps:
        by_scaffold.setdefault(g.scaffold_id, []).append(g)
    out = []
    n_closed = 0
    for si, s in enumerate(scaffolds):
        glist = sorted(by_scaffold.get(si + 1, []), key=lambda g: g.start)
        parts = []
        pos = 0
        for g in glist:
            parts.append(s[pos: g.start])
            if g.state == UNCLOSED or g.closing_seq is None:
                parts.append(s[g.start: g.end])
            else:
                if g.closing_length >= 0:
                    parts.append(g.closing_seq)
                else:
                    # negative closure: flanks overlap; trim the emitted head
                    trim = -g.closing_length
                    prev = parts[-1]
                    parts[-1] = prev[: len(prev) - trim]
                n_closed += 1
            pos = g.end
        parts.append(s[pos:])
        out.append(np.concatenate(parts) if parts else s)
    LOG.counter("NUM_CLOSED_GAPS_TOTAL", n_closed)
    return out


# ---------------------------------------------------------------------------
# single-read small-gap path (-f)
# ---------------------------------------------------------------------------

# gapClose.cpp:39
MIN_NUM_READS_COVERING_SMALL_GAP = 1


def map_small_gap(scaffolds: list[np.ndarray], codes: np.ndarray,
                  lengths: np.ndarray, seed_length: int = 32) -> list:
    """mapSmallGap (mapper.cpp:1039-1263): single reads whose two end
    seeds anchor the same scaffold around a small gap contribute the read
    segment spanning it.

    Returns records [(scaffold id 1-based, gap-anchor offset, segment codes
    (possibly empty) , signed segment length)] — the gapSeqFP stream. A
    negative length means the read says the flanks overlap.

    NOTE: the reference computes this for -f reads (gapClose.cpp:196) but
    its consumer closeSmallGaps is commented out (:225); close_small_gaps
    below is therefore opt-in."""
    # exact seed-position table over scaffolds (keyLength=32 seeds)
    table: dict[bytes, list] = {}
    for si, s in enumerate(scaffolds):
        if len(s) < seed_length:
            continue
        win = np.lib.stride_tricks.sliding_window_view(s, seed_length)
        ok = (win < 4).all(axis=1)
        for off in np.nonzero(ok)[0]:
            table.setdefault(win[off].tobytes(), []).append((si + 1,
                                                             int(off)))

    records = []
    n_reads = len(lengths)
    for ri in range(n_reads):
        L = int(lengths[ri])
        if L < 2 * seed_length:
            continue
        read = codes[ri, :L]
        head = read[:seed_length]
        tail = read[-seed_length:]
        if (head >= 4).any() or (tail >= 4).any():
            continue
        for rev in (False, True):
            r = read if not rev else _rc_gc(read)
            h = r[:seed_length].tobytes()
            t = r[-seed_length:].tobytes()
            hits_l = table.get(h, ())
            hits_r = table.get(t, ())
            hit = None
            for sid, off_l in hits_l:
                for sid2, off_r in hits_r:
                    if (sid2 != sid or off_r <= off_l
                            or off_r - off_l + seed_length > 2 * L):
                        continue
                    hit = (sid, off_l, off_r)
                    break
                if hit:
                    break
            if hit is None:
                continue
            sid, off_l, off_r = hit
            s = scaffolds[sid - 1]
            # first/last N between the seeds (searchGapStart/End)
            start = 0
            for i in range(off_l + seed_length, off_r):
                if s[i] == 4:
                    start = i - off_l
                    break
            if start == 0:
                continue
            end = 0
            for i in range(off_r - 1, off_l + seed_length - 1, -1):
                if s[i] == 4:
                    end = L - (off_r + seed_length - 1 - i)
                    break
            if end == 0:
                continue
            seg_len = end - start
            seg = r[start:end] if seg_len > 0 else np.zeros(0, np.uint8)
            records.append((sid, off_l + start, seg, seg_len))
            break
    LOG.counter("NUM_SMALL_GAP_READS", len(records))
    return records


def _rc_gc(codes: np.ndarray) -> np.ndarray:
    out = codes[::-1].copy()
    m = out < 4
    out[m] = 3 - out[m]
    return out


def close_small_gaps(gaps: list[Gap], scaffolds: list[np.ndarray],
                     records: list, consensus_rate: float = 0.9) -> int:
    """closeSmallGaps + decideConsensusFromReads (gapClose.cpp:872-1010):
    per gap, majority segment length (rate >= threshold), then per-column
    base consensus; negative lengths validate flank overlap against the
    scaffold. DISABLED at the reference call site (gapClose.cpp:225) —
    callers opt in explicitly."""
    by_pos: dict[tuple[int, int], int] = {}
    for gi, g in enumerate(gaps):
        for p in range(g.start, g.end):
            by_pos[(g.scaffold_id, p)] = gi
    per_gap: dict[int, list] = {}
    for sid, off, seg, seg_len in records:
        gi = by_pos.get((sid, off))
        if gi is None:
            continue
        per_gap.setdefault(gi, []).append((seg, seg_len))
    n_closed = 0
    for gi, lst in per_gap.items():
        if len(lst) < MIN_NUM_READS_COVERING_SMALL_GAP:
            continue
        lens = [sl for _s, sl in lst]
        vals, cnts = np.unique(lens, return_counts=True)
        best = int(np.argmax(cnts))
        most_len = int(vals[best])
        if cnts[best] / len(lst) < consensus_rate:
            continue
        g = gaps[gi]
        if most_len <= 0:
            # flank-overlap closure: bases before the gap must equal the
            # bases most_len before the gap end (gapClose.cpp:907-918)
            s = scaffolds[g.scaffold_id - 1]
            ok = True
            for i in range(-most_len):
                a = s[g.start - i - 1]
                b = s[g.end - most_len - i - 1]
                if a != b or a == 4 or b == 4:
                    ok = False
                    break
            if not ok:
                continue
            g.closing_length = most_len - 1
            g.closing_seq = np.zeros(0, np.uint8)
        else:
            mat = np.stack([s for s, sl in lst if sl == most_len])
            cons = np.zeros(most_len, np.uint8)
            agree = 0
            for i in range(most_len):
                bc = np.bincount(mat[:, i], minlength=5)[:4]
                cons[i] = np.argmax(bc)
                agree += int(bc.max())
            if agree / (most_len * len(mat)) < consensus_rate:
                continue
            g.closing_length = most_len
            g.closing_seq = cons
        g.state = CLOSED
        n_closed += 1
    LOG.counter("NUM_CLOSED_SMALL_GAP", n_closed)
    return n_closed


# ---------------------------------------------------------------------------
# circular sequence detection (disabled at the reference call site)
# ---------------------------------------------------------------------------

def self_overlap(seq: np.ndarray, min_overlap: int = MIN_OVERLAP_FOR_CIRCLE
                 ) -> int:
    """selfOverlap (gapClose.cpp:1183-1198): longest exact overlap of the
    sequence's tail onto its own head (>= min_overlap), else 0."""
    n = len(seq)
    for i in range(n - 1, min_overlap - 1, -1):
        if np.array_equal(seq[:i], seq[n - i:]):
            return i
    return 0


def find_circular_seqs(seqs: list[np.ndarray]) -> list[bool]:
    """findCircularGapClosedSeq (gapClose.cpp:1169-1181): trim the
    self-overlap off circular sequences. Mutates seqs in place, returns
    circular flags. DISABLED at the reference call site (:272) — opt-in."""
    flags = []
    for i, s in enumerate(seqs):
        ov = self_overlap(s, MIN_OVERLAP_FOR_CIRCLE)
        if ov >= MIN_OVERLAP_FOR_CIRCLE:
            seqs[i] = s[: len(s) - ov]
            flags.append(True)
        else:
            flags.append(False)
    LOG.counter("NUM_CIRCULAR_SEQS", sum(flags))
    return flags
