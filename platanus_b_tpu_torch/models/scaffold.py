"""Scaffold graph: PE-link scaffolding of contigs (consensus path).

Re-design of ScaffoldGraph / the PairedDBG subset used by
`solve_DBG -unphase` (scaffoldGraph.h:37-447, scaffoldGraph.cpp,
pairedDBG.cpp). The graph is small (thousands of nodes), so graph
manipulation is host-side Python/numpy — the idiomatic TPU split puts only
read mapping and overlap detection on device (models.mapper).

Implemented behaviors (with reference cites):
- contig-end overlap table         <- saveOverlap (scaffoldGraph.cpp:90-254)
                                      + getShortOverlap (:284-325)
- link store/lift to node coords   <- storeGraphLinkFromMappedPair (:444-520)
- link aggregation + gap estimate  <- calcLink/estimateGapSizeAverage (:718-864)
- graph build                      <- makeGraph (:866-923)
- edge cleaning                    <- deleteThinEdge (:953-978, Gaussian
                                      expected-link model scaffoldGraph.h:453-474),
                                      deleteErroneousEdge(Iterative) (:1004-1146),
                                      deleteRepeatEdge (:1148-1190)
- repeat detection                 <- detectRepeat (:1194-1231)
- greedy scaffolding + remake      <- makeScaffold (:1370-1573), remake (:1579)
- sequence output                  <- loadResultSeq (pairedDBG.cpp:2048-2230)

Port copy of platanus_b_tpu/models/scaffold.py: the reference's text, its
relative imports resolving to the port's modules (mapper, seqlib, phasing, log).
One adaptation, in ``save_overlap``: the port's ``ContigIndex`` holds its
key table as int64 lanes and its positions as a tensor on its device, so
both are converted once to the reference's uint32 words and numpy
positions (ops/keys.py keys_to_words) before the unchanged lookup loop.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..utils.log import LOG
from ..ops.keys import keys_to_words
from .mapper import ContigIndex
from .seqlib import MappedPairs, PairLibrary

# scaffoldGraph.cpp:39-40
EDGE_EXPECTED_RATE_TH = 0.5
EDGE_EXPECTED_RATE_UPPER_TH = 4.0
# node state flags (scaffoldGraph.cpp)
SC_INC = 0x1
SC_REP = 0x2
SC_DEL = 0x4
# PairedDBG node state flags (pairedDBG.cpp:38-40)
DBG_HETERO = 0x8
DBG_PRIMARY_BUBBLE = 0x10
DBG_SECONDARY_BUBBLE = 0x20
# pairedDBG.cpp:63
HETERO_COVERAGE_THRESHOLD_FACTOR = 1.75
# scaffold.cpp:42-43 (solveDBG inherits)
MIN_TOL_FACTOR = 2
MAX_TOL_FACTOR = 2
# loadResultSeq (pairedDBG.cpp:2050-2051)
MIN_GAP_LENGTH = 10
MIN_OVERLAP_TO_JOIN = 32
# scaffoldGraph.cpp:48
MIN_NUM_MAPPED_TAG = 3
# pairedDBG.cpp:60,64-65
MAX_ITERATION_OF_CROSS_SOLUTION = 5
CROSS_LINK_RATE_THRESHOLD = 0.25
CROSS_SCORE_RATE_THRESHOLD = 0.5
# contig-level bubble state flags (pairedDBG.h DBG_CONTIG_*)
DBG_CONTIG_PRIMARY_BUBBLE = 0x1
DBG_CONTIG_SECONDARY_BUBBLE = 0x2
DBG_CONTIG_BUBBLE_JUNCTION = 0x4


@dataclass
class GraphEdge:
    direction: int   # +1: extends node's right end; -1: left end
    end: int         # signed neighbor node id (1-based)
    length: int      # estimated gap
    num_link: int
    breakdown: np.ndarray | None = None  # per-contig link counts of the node
    score: int = 0


@dataclass
class GraphNode:
    length: int
    contigs: list              # [(signed contig id 1-based, start, end)]
    edges: list = field(default_factory=list)
    state: int = 0
    is_homo: bool = False      # classifyNode (scaffoldGraph.cpp:403-421)
    opposite_bubble_node_id: int = 0  # signed (pairedDBG GraphNode)


@dataclass
class ResultSeq:
    seq: np.ndarray
    name: str
    component: str
    redundant: bool = False
    node_index: int = -1   # source node (for bubble pairing outputs)


class ScaffoldGraph:
    def __init__(self, contigs: list[np.ndarray], coverages: np.ndarray,
                 names: list[str] | None = None, min_overlap: int = 31,
                 hash_overlap: int = 32, seed_length: int = 32):
        self.contig = [np.asarray(c, np.uint8) for c in contigs]
        self.coverage = np.asarray(coverages, np.float64)
        self.names = names or [f"contig{i+1}" for i in range(len(contigs))]
        self.num_contig = len(contigs)
        self.min_overlap = min_overlap
        # strict-parity DBG_OVERLAP gate (see _node_overlap_adjacency)
        self.strict_dbg_overlap = False
        self.hash_overlap = hash_overlap
        self.seed_length = seed_length
        self.tolerence = 0
        self.min_link = 3
        lens = np.array([len(c) for c in self.contig], dtype=np.float64)
        tot = max(lens.sum(), 1.0)
        self.average_coverage = float((self.coverage * lens).sum() / tot)
        # one node per contig initially (initScaffolding)
        self.node: list[GraphNode] = [
            GraphNode(length=len(c), contigs=[(i + 1, 0, len(c))])
            for i, c in enumerate(self.contig)]
        # contigPositionInScaffold: (signed node id, index in node), id 0 =
        # excluded (repeat-divided)
        self.contig_pos_id = np.arange(1, self.num_contig + 1, dtype=np.int64)
        self.contig_pos_off = np.zeros(self.num_contig, dtype=np.int64)
        self.overlap_table: dict[tuple[int, int], int] = {}
        # per-library state set by the driver
        self.lib: PairLibrary | None = None
        self.pairs: MappedPairs | None = None
        # 10x tag counts per (tag, contig) — set by set_contig_tag_counts
        self.contig_tag: tuple[np.ndarray, np.ndarray, np.ndarray] | None = None
        # contig pairs unlinked by base-level division (contigUnlinkSet,
        # pairedDBG.cpp:99,7282): encoded min(ci)*num_contig+max(ci)
        self.contig_unlink: set[int] = set()
        # previous parent node per contig (contigPreviousParentNodeID,
        # pairedDBG.cpp:4930-4997), for PREVIOUS_DIVISION_AWARE_MODE
        self.contig_prev_parent = np.zeros(self.num_contig, dtype=np.int64)
        # hetero/bubble machinery state (models.hetero)
        self.hetero_coverage = 0.0     # PairedDBG::heteroCoverage
        self.bubble_threshold = 0.1    # -u (bubbleThreshold); 0 disables
        # numBubble per contig (scaffoldGraph.cpp:372,397; set by
        # hetero.merge_bubble from crushed-bubble mapping)
        self.num_bubble = np.zeros(self.num_contig, dtype=np.int64)
        # oppositeBubbleContigID (pairedDBG.cpp:2613-2708): signed contig id
        self.opposite_bubble_contig_id = np.zeros(self.num_contig,
                                                  dtype=np.int64)
        # crushed-bubble output records: (codes, coverage) — bubbleFP
        self.crushed_bubbles: list = []
        # crushed (secondary codes, primary rep contig index 1-based)
        # pairs — bubbleFP/bubbleOpositeFP channel
        self.bubble_pairs: list = []
        # contigState (pairedDBG.h): DBG_CONTIG_* flags per contig
        self.contig_state = np.zeros(self.num_contig, dtype=np.int64)
        # joinedBubbleContigID (pairedDBG.cpp:3412-3489): per contig, the
        # [left, right] neighbor contig ids joined across bubble junctions
        self.joined_bubble_contig_id = np.zeros((self.num_contig, 2),
                                                dtype=np.int64)
        # contigMaxK (_maxK header field); set by drivers that know it
        self.contig_max_k = hash_overlap

    # -- node coverage (calcNodeCoverage: length-weighted contig coverage) --
    def node_coverage(self, n: GraphNode) -> float:
        s = 0.0
        ln = 0
        for cid, st, ed in n.contigs:
            i = abs(cid) - 1
            s += self.coverage[i] * len(self.contig[i])
            ln += len(self.contig[i])
        return s / max(ln, 1)

    # ------------------------------------------------------------------
    # overlap table (saveOverlap, scaffoldGraph.cpp:90-254)
    # ------------------------------------------------------------------
    def save_overlap(self, index: ContigIndex, cutoff_length: int) -> None:
        LOG.info(f"saving overlaps... (LEN_CUTOFF={cutoff_length})")
        key = index.key_length
        kt = keys_to_words(index.key_table, index.key_length)
        kp = index.key_pos.cpu().numpy()
        tl = index.table_len
        W = kt.shape[1]
        if tl == 0:
            return
        packed = _pack64(kt[:tl])

        def postings(codes: np.ndarray):
            """mapSeed: postings for fwd key + rev-complement key, signed."""
            out = []
            for sign, q in ((1, codes), (-1, _rc_np(codes))):
                pk = _pack64_row(_codes_to_key(q, W))
                lo = np.searchsorted(packed, pk, side="left")
                hi = np.searchsorted(packed, pk, side="right")
                for t in range(lo, hi):
                    gpos = int(kp[t])
                    cid = int(np.searchsorted(index.starts, gpos,
                                              side="right")) - 1
                    out.append((sign * (cid + 1), gpos - int(index.starts[cid])))
            return out

        for i, c in enumerate(self.contig):
            if len(c) < cutoff_length or len(c) < key:
                continue
            left = c[:key]
            right = c[len(c) - key:]
            if not (left > 3).any():
                self._overlap_from_end(i, left, postings(left), is_left=True,
                                       cutoff_length=cutoff_length)
            if not (right > 3).any():
                self._overlap_from_end(i, right, postings(right), is_left=False,
                                       cutoff_length=cutoff_length)

        # exact SHORT overlaps (min_overlap <= ov < key), which the
        # key-length seed map cannot see — notably the canonical maxK-1
        # de-Bruijn overlaps (getShortOverlap semantics,
        # scaffoldGraph.cpp:284-325, tabulated so getOverlappedNode /
        # bubble scans observe them)
        for ov in range(self.min_overlap, key):
            heads: dict[bytes, list[int]] = {}
            for j, t in enumerate(self.contig):
                if len(t) < cutoff_length or len(t) < ov:
                    continue
                p = t[:ov]
                if not (p > 3).any():
                    heads.setdefault(p.tobytes(), []).append(j + 1)
                rp = _rc_np(t[len(t) - ov:])
                if not (rp > 3).any():
                    heads.setdefault(rp.tobytes(), []).append(-(j + 1))
            for i, c in enumerate(self.contig):
                if len(c) < cutoff_length or len(c) < ov:
                    continue
                s = c[len(c) - ov:]
                if (s > 3).any():
                    continue
                for pid in heads.get(s.tobytes(), ()):
                    j = abs(pid) - 1
                    if j == i:
                        continue
                    if j > i:
                        k2 = (i + 1, pid)
                    else:
                        k2 = (-pid, -(i + 1))
                    self.overlap_table[k2] = max(
                        self.overlap_table.get(k2, 0), ov)

    def _overlap_from_end(self, i, kmer, posts, is_left, cutoff_length):
        key = len(kmer)
        c = self.contig[i]
        for pid, off in posts:
            j = abs(pid) - 1
            # avoid double counting i<->j and self-mapping
            # (scaffoldGraph.cpp:143-145,218-220: skip abs(id)-1 <= i)
            if j <= i:
                continue
            t = self.contig[j]
            if len(t) < cutoff_length:
                continue
            if is_left:
                # contig i's LEFT end extends backwards into t
                if pid > 0:
                    ov = len(t) - off
                    if not (self.min_overlap <= ov <= len(c)):
                        continue
                    if ov > key and not np.array_equal(c[key:ov],
                                                       t[off + key: off + ov]):
                        continue
                else:
                    ov = off + key
                    if not (self.min_overlap <= ov <= len(c)):
                        continue
                    seg = t[off + key - ov: off][::-1]
                    if ov > key and not np.array_equal(c[key:ov],
                                                       np.where(seg < 4, 3 - seg, seg)):
                        continue
                self.overlap_table[(-(i + 1), -pid)] = max(
                    self.overlap_table.get((-(i + 1), -pid), 0), ov)
            else:
                if pid > 0:
                    ov = off + key
                    if not (self.min_overlap <= ov <= len(c)):
                        continue
                    if ov > key and not np.array_equal(
                            c[len(c) - ov: len(c) - key], t[off - (ov - key): off]):
                        continue
                else:
                    ov = len(t) - off
                    if not (self.min_overlap <= ov <= len(c)):
                        continue
                    seg = t[off + key: off + ov][::-1]
                    if ov > key and not np.array_equal(
                            c[len(c) - ov: len(c) - key],
                            np.where(seg < 4, 3 - seg, seg)):
                        continue
                self.overlap_table[(i + 1, pid)] = max(
                    self.overlap_table.get((i + 1, pid), 0), ov)

    def get_overlap(self, id1: int, id2: int) -> int:
        """getOverlap (scaffoldGraph.cpp:254-278) on CONTIG ids."""
        if abs(id1) > abs(id2):
            id1, id2 = -id2, -id1
        v = self.overlap_table.get((id1, id2))
        if v is not None:
            return v
        return self._short_overlap(id1, id2)

    def _short_overlap(self, id1: int, id2: int) -> int:
        """getShortOverlap (scaffoldGraph.cpp:284-325): exact suffix(id1)/
        prefix(id2) overlaps of length hash_overlap..min_overlap."""
        c1 = self.contig[abs(id1) - 1]
        c2 = self.contig[abs(id2) - 1]
        s1 = c1 if id1 > 0 else _rc_np(c1)
        s2 = c2 if id2 > 0 else _rc_np(c2)
        top = min(self.hash_overlap, len(s1), len(s2))
        for ov in range(top, self.min_overlap - 1, -1):
            a = s1[len(s1) - ov:]
            b = s2[:ov]
            if (a < 4).all() and np.array_equal(a, b):
                return ov
        return 0

    def scaffold_overlap(self, id1: int, id2: int) -> int:
        """getScaffoldOverlap (scaffoldGraph.cpp:344-356): map node ids to
        their terminal contig ids."""
        n1 = self.node[abs(id1) - 1]
        n2 = self.node[abs(id2) - 1]
        e1 = n1.contigs[-1][0] if id1 > 0 else -n1.contigs[0][0]
        e2 = n2.contigs[0][0] if id2 > 0 else -n2.contigs[-1][0]
        return self.get_overlap(e1, e2)

    # ------------------------------------------------------------------
    # links (storeGraphLinkFromMappedPair + calcLink)
    # ------------------------------------------------------------------
    def lift_arrays(self):
        """Per-contig lift tables: (signed node id, start-in-node, part
        index, contig length). contigPositionInScaffold + ScaffoldPart.start
        as columnar arrays — every batched lift (links, coverage tracks)
        indexes these instead of walking node.contigs per record."""
        cst = np.zeros(self.num_contig, dtype=np.int64)
        for ni, n in enumerate(self.node):
            for k, (cid, st, _ed) in enumerate(n.contigs):
                ci = abs(cid) - 1
                if abs(self.contig_pos_id[ci]) == ni + 1 \
                        and self.contig_pos_off[ci] == k:
                    cst[ci] = st
        clen = np.array([len(c) for c in self.contig], dtype=np.int64)
        return self.contig_pos_id, cst, self.contig_pos_off.copy(), clen

    def lift_positions(self, ids: np.ndarray, offs: np.ndarray,
                       lift=None):
        """Vectorized contig->node position lift. Returns (signed node id
        with 0 = excluded, node offset, part index)."""
        if lift is None:
            lift = self.lift_arrays()
        nid_of, cst, part, clen = lift
        ci = np.abs(ids) - 1
        nid = np.where(ids != 0, nid_of[ci], 0)
        sid = np.where(ids > 0, nid, -nid)
        o = np.where(nid > 0, offs, clen[ci] - offs - 1) + cst[ci]
        return sid, o, part[ci]

    def store_links(self) -> np.ndarray:
        """storeGraphLinkFromMappedPair (scaffoldGraph.cpp:444-520),
        vectorized: lift cross-contig pair records to node coords, emit raw
        links as an (N, 5) array [id1, off1, id2, off2, gap]."""
        mp = self.pairs
        lib = self.lib
        cutoff = max(self.tolerence, self.seed_length) * 2
        node_len = np.array([n.length for n in self.node], dtype=np.int64)
        lift = self.lift_arrays()

        fid, foff = mp.link_fwd_id, mp.link_fwd_off
        rid, roff = mp.link_rev_id, mp.link_rev_off
        # contigUnlinkSet filter (pairedDBG.cpp:99): drop pairs whose contig
        # pair was unlinked by a previous division
        if self.contig_unlink:
            cf = np.abs(fid) - 1
            cr = np.abs(rid) - 1
            code = (np.minimum(cf, cr) * self.num_contig
                    + np.maximum(cf, cr))
            keep = ~np.isin(code, np.fromiter(self.contig_unlink, np.int64))
            fid, foff, rid, roff = fid[keep], foff[keep], rid[keep], roff[keep]

        f_sid, f_off, f_part = self.lift_positions(fid, foff, lift)
        r_sid, r_off, r_part = self.lift_positions(rid, roff, lift)
        keep = (f_sid != 0) & (r_sid != 0) & (np.abs(f_sid) != np.abs(r_sid))
        keep &= (node_len[np.abs(f_sid) - 1] >= cutoff) \
            & (node_len[np.abs(r_sid) - 1] >= cutoff)
        f_sid, f_off, f_part = f_sid[keep], f_off[keep], f_part[keep]
        r_sid, r_off, r_part = r_sid[keep], r_off[keep], r_part[keep]

        gap = np.full(len(f_sid), int(lib.average_insert), dtype=np.int64)
        gap -= np.where(f_sid > 0, node_len[np.abs(f_sid) - 1] - f_off,
                        f_off + 1)
        gap -= np.where(r_sid > 0, node_len[np.abs(r_sid) - 1] - r_off,
                        r_off + 1)

        f_first = np.abs(f_sid) < np.abs(r_sid)
        id1 = np.where(f_first, f_sid, r_sid)
        off1 = np.where(f_first, f_part, r_part)
        id2 = np.where(f_first, -r_sid, -f_sid)
        off2 = np.where(f_first, r_part, f_part)

        # overlap-aware proximity filter: only records with -gap > tolerence
        # even need an overlap lookup (small subset)
        ok = -gap <= self.tolerence
        check = np.nonzero(~ok)[0]
        for k in check:
            if -gap[k] <= self.tolerence + self.scaffold_overlap(
                    int(id1[k]), int(id2[k])):
                ok[k] = True
        return np.stack([id1, off1, id2, off2, gap],
                        axis=1)[ok].astype(np.int64)

    def make_graph(self) -> None:
        """calcLink + makeGraph (scaffoldGraph.cpp:718-923)."""
        LOG.info("linking scaffolds...")
        links = self.store_links()
        for n in self.node:
            n.edges = []
        if len(links) == 0:
            return
        order = np.lexsort((links[:, 4], links[:, 2], links[:, 0]))
        links = links[order]
        keys = links[:, [0, 2]]
        new_grp = np.ones(len(links), dtype=bool)
        new_grp[1:] = (keys[1:] != keys[:-1]).any(axis=1)
        starts = np.nonzero(new_grp)[0]
        ends = np.append(starts[1:], len(links))
        LOG.info("estimating contig distances...")
        for s, e in zip(starts, ends):
            if e - s < self.min_link:
                continue
            id1, id2 = int(links[s, 0]), int(links[s, 2])
            gap = int(math.floor(links[s:e, 4].mean() + 0.5))
            num_link = int(e - s)
            i, j = abs(id1) - 1, abs(id2) - 1
            bd1 = np.zeros(len(self.node[i].contigs), dtype=np.int64)
            bd2 = np.zeros(len(self.node[j].contigs), dtype=np.int64)
            np.add.at(bd1, links[s:e, 1], 1)
            np.add.at(bd2, links[s:e, 3], 1)
            d1 = 1 if id1 > 0 else -1
            d2 = 1 if -id2 > 0 else -1
            end1 = (j + 1) if id1 * id2 > 0 else -(j + 1)
            end2 = (i + 1) if id1 * id2 > 0 else -(i + 1)
            self.node[i].edges.append(GraphEdge(d1, end1, gap, num_link, bd1))
            self.node[j].edges.append(GraphEdge(d2, end2, gap, num_link, bd2))
        for n in self.node:
            n.edges.sort(key=lambda e: (e.direction, e.end))

    # ------------------------------------------------------------------
    # long-read links (storeGraphLinkFromMappedLongRead,
    # pairedDBG.cpp:312-448)
    # ------------------------------------------------------------------
    def store_links_long(self, read_records) -> np.ndarray:
        """Lift per-read alignment records to node coords and emit links
        between every node pair a read spans: (N, 6) [id1, off1, id2, off2,
        gap, score]."""
        out = []
        for _name, (read_len, recs) in read_records.items():
            lifted = {}
            for r in recs:
                ci = abs(r.position_id) - 1
                nid = self.contig_pos_id[ci]
                if nid == 0:
                    continue
                sid = nid if r.position_id > 0 else -nid
                o = (r.position_offset if nid > 0
                     else len(self.contig[ci]) - r.position_offset - 1)
                n = self.node[abs(sid) - 1]
                _c, cst, _e = n.contigs[self.contig_pos_off[ci]]
                key = (int(sid), int(o + cst))
                ent = lifted.get(key)
                if ent is None:
                    lifted[key] = [r.score, int(self.contig_pos_off[ci])]
                else:
                    ent[0] += r.score  # merge same-position alignments
            merged = [(sid, off, sc, cidx)
                      for (sid, off), (sc, cidx) in lifted.items()]
            for a in range(len(merged) - 1):
                for b in range(a + 1, len(merged)):
                    id_a, off_a, sc_a, ci_a = merged[a]
                    id_b, off_b, sc_b, ci_b = merged[b]
                    if abs(id_a) == abs(id_b):
                        continue
                    len_a = self.node[abs(id_a) - 1].length
                    len_b = self.node[abs(id_b) - 1].length
                    if id_a > 0:
                        fl, fr = -off_a, len_a - off_a - 1
                    else:
                        fl, fr = -(len_a - off_a - 1), off_a
                    if id_b > 0:
                        rl, rr = -off_b, len_b - off_b - 1
                    else:
                        rl, rr = -(len_b - off_b - 1), off_b
                    if fl <= rl:
                        if fr > rr:
                            continue
                        gap = -(fr - rl + 1)
                    else:
                        if rr > fr:
                            continue
                        gap = -(rr - fl + 1)
                    if abs(id_a) < abs(id_b):
                        if fr < rr:
                            id1, o1, id2, o2 = id_a, ci_a, id_b, ci_b
                        else:
                            id1, o1, id2, o2 = -id_a, ci_a, -id_b, ci_b
                    else:
                        if fr < rr:
                            id1, o1, id2, o2 = -id_b, ci_b, -id_a, ci_a
                        else:
                            id1, o1, id2, o2 = id_b, ci_b, id_a, ci_a
                    if -gap > self.tolerence:
                        continue
                    out.append((id1, o1, id2, o2, gap, sc_a + sc_b))
        return np.array(out, dtype=np.int64).reshape(-1, 6)

    def make_graph_long(self, read_records) -> None:
        """Long-read link graph (makeGraph in LONG_READ_LINK_MODE)."""
        LOG.info("linking scaffolds with long reads...")
        links = self.store_links_long(read_records)
        for n in self.node:
            n.edges = []
        if len(links) == 0:
            return
        order = np.lexsort((links[:, 4], links[:, 2], links[:, 0]))
        links = links[order]
        keys = links[:, [0, 2]]
        new_grp = np.ones(len(links), dtype=bool)
        new_grp[1:] = (keys[1:] != keys[:-1]).any(axis=1)
        starts = np.nonzero(new_grp)[0]
        ends = np.append(starts[1:], len(links))
        for s, e in zip(starts, ends):
            if e - s < self.min_link:
                continue
            id1, id2 = int(links[s, 0]), int(links[s, 2])
            gap = int(math.floor(links[s:e, 4].mean() + 0.5))
            score = int(links[s:e, 5].sum())
            num_link = int(e - s)
            i, j = abs(id1) - 1, abs(id2) - 1
            d1 = 1 if id1 > 0 else -1
            d2 = 1 if -id2 > 0 else -1
            end1 = (j + 1) if id1 * id2 > 0 else -(j + 1)
            end2 = (i + 1) if id1 * id2 > 0 else -(i + 1)
            self.node[i].edges.append(GraphEdge(d1, end1, gap, num_link,
                                                None, score))
            self.node[j].edges.append(GraphEdge(d2, end2, gap, num_link,
                                                None, score))
        for n in self.node:
            n.edges.sort(key=lambda e: (e.direction, e.end))

    def delete_erroneous_edge_score(self, rate: float) -> int:
        """deleteErroneousEdgeScore (pairedDBG.cpp): of two conflicting
        edges, drop the one whose score is < rate * the other's."""
        total = 0
        while True:
            ids = []
            for ni, n in enumerate(self.node):
                for a in range(len(n.edges) - 1):
                    for b in range(a + 1, len(n.edges)):
                        e1, e2 = n.edges[a], n.edges[b]
                        n1 = self.node[abs(e1.end) - 1]
                        n2 = self.node[abs(e2.end) - 1]
                        if not self._check_delete_edge(e1, e2, n1, n2):
                            continue
                        if e1.score < rate * e2.score:
                            ids.append((ni + 1, e1.end))
                        elif e2.score < rate * e1.score:
                            ids.append((ni + 1, e2.end))
            self.delete_edges(ids)
            total += len(ids)
            if not ids:
                break
        return total

    # ------------------------------------------------------------------
    # expected links + edge cleaning
    # ------------------------------------------------------------------
    def calc_expected_link(self, coverage, len1, len2, g) -> float:
        """calcExpectedLink (scaffoldGraph.h:453-474)."""
        ins = float(self.lib.average_insert)
        sd = max(float(self.lib.sd_insert), 1e-9)
        av = max(float(self.lib.average_length), 1.0)
        s2 = math.sqrt(2.0) * sd

        def term(x):
            return x * math.erf(x / s2) + (s2 / math.sqrt(math.pi)) * math.exp(-(x / s2) ** 2)

        n = (term(len1 + g - ins + len2) - term(av + g - ins + len2)
             - term(len1 + g - ins + av) + term(av + g - ins + av))
        return n * coverage / (4.0 * av)

    def estimate_link(self) -> int:
        """estimateLink (scaffoldGraph.cpp:331-338)."""
        mean_len = sum(len(c) for c in self.contig) / max(self.num_contig, 1)
        g = float(self.lib.average_insert) - 2.0 * float(self.lib.average_length)
        return int(max(1.0, self.calc_expected_link(
            self.average_coverage, mean_len, mean_len, g)))

    def _check_delete_edge(self, e1: GraphEdge, e2: GraphEdge,
                           n1: GraphNode, n2: GraphNode) -> bool:
        """checkDeleteEdge (scaffoldGraph.cpp:928-950): true when e1/e2 are
        same-direction alternatives that cannot coexist in one layout."""
        if (e1.direction * e2.direction < 0
                or e1.length + n1.length <= e2.length
                or e2.length + n2.length <= e1.length):
            return False
        if e1.direction > 0:
            a, b = e1.end, e2.end
        else:
            a, b = e2.end, e1.end
        if (abs(e1.length + n1.length - e2.length)
                <= self.tolerence + self.scaffold_overlap(a, b)
                or abs(e2.length + n2.length - e1.length)
                <= self.tolerence + self.scaffold_overlap(b, a)):
            return False
        return True

    def delete_edges(self, ids: list[tuple[int, int]]) -> None:
        for id1, id2 in ids:
            if id2 == 0:
                continue
            n = self.node[id1 - 1]
            n.edges = [e for e in n.edges if e.end != id2]
            # reciprocal edge (deleteEdges, scaffoldGraph.cpp:1236-1280):
            # same-sign pair -> ends at +id1, opposite-sign -> -id1
            m = self.node[abs(id2) - 1]
            recip = id1 if id2 > 0 else -id1
            m.edges = [e for e in m.edges if e.end != recip]

    def delete_thin_edge(self, link_threshold: int) -> None:
        """deleteThinEdge (scaffoldGraph.cpp:953-978)."""
        LOG.info(f"removing thin edges (NUM_LINK < min({link_threshold}, "
                 "EXPECTED_NUM_LINK)) ...")
        ids = []
        for ni, n1 in enumerate(self.node):
            for e in n1.edges:
                n2 = self.node[abs(e.end) - 1]
                cov1 = (self.lib.average_coverage * self.node_coverage(n1)
                        / max(self.average_coverage, 1e-9))
                cov2 = (self.lib.average_coverage * self.node_coverage(n2)
                        / max(self.average_coverage, 1e-9))
                exp = int(self.calc_expected_link(
                    min(cov1, cov2), n1.length, n2.length,
                    max(float(self.lib.average_insert), 0.0)) + 0.5)
                if e.num_link < min(link_threshold, exp):
                    ids.append((ni + 1, e.end))
        LOG.counter("TOTAL_NUM_DELETE", len(ids))
        self.delete_edges(ids)

    def delete_erroneous_edge(self) -> int:
        """deleteErroneousEdge (scaffoldGraph.cpp:1004-1049)."""
        ids = []
        for ni, n in enumerate(self.node):
            for a in range(len(n.edges) - 1):
                for b in range(a + 1, len(n.edges)):
                    e1, e2 = n.edges[a], n.edges[b]
                    n1 = self.node[abs(e1.end) - 1]
                    n2 = self.node[abs(e2.end) - 1]
                    if not self._check_delete_edge(e1, e2, n1, n2):
                        continue
                    r1 = e1.num_link / max(1.0, self.calc_expected_link(
                        self.lib.average_coverage, n.length, n1.length,
                        e1.length))
                    if r1 > EDGE_EXPECTED_RATE_UPPER_TH:
                        continue
                    r2 = e2.num_link / max(1.0, self.calc_expected_link(
                        self.lib.average_coverage, n.length, n2.length,
                        e2.length))
                    if r2 > EDGE_EXPECTED_RATE_UPPER_TH:
                        continue
                    if e1.num_link < e2.num_link and r1 / max(r2, 1e-12) <= EDGE_EXPECTED_RATE_TH:
                        ids.append((ni + 1, e1.end))
                    elif e2.num_link < e1.num_link and r2 / max(r1, 1e-12) <= EDGE_EXPECTED_RATE_TH:
                        ids.append((ni + 1, e2.end))
        self.delete_edges(ids)
        return len(ids)

    def delete_erroneous_edge_iterative(self) -> int:
        LOG.info("removing erroneous edges...")
        total = 0
        while True:
            n = self.delete_erroneous_edge()
            LOG.counter("NUM_REMOVED_EDGES", n)
            if n == 0:
                break
            total += n
        return total

    # ------------------------------------------------------------------
    # 10x tag edges (countMappedTagForEachScaffold scaffoldGraph.cpp:593,
    # deleteErroneousEdgeNumTagRate pairedDBG.cpp:4458-4515)
    # ------------------------------------------------------------------
    def set_contig_tag_counts(self, tag_ids: np.ndarray,
                              contig_idx: np.ndarray,
                              counts: np.ndarray) -> None:
        self.contig_tag = (np.asarray(tag_ids, np.int64),
                           np.asarray(contig_idx, np.int64),
                           np.asarray(counts, np.int64))

    def _node_tag_counts(self) -> list[dict]:
        """Lift per-(tag, contig) counts onto current nodes, dropping tags
        mapped < MIN_NUM_MAPPED_TAG times (scaffoldGraph.cpp:48,604)."""
        node_tags: list[dict] = [dict() for _ in self.node]
        if self.contig_tag is None:
            return node_tags
        tag_ids, contig_idx, counts = self.contig_tag
        nid = self.contig_pos_id[contig_idx]
        keep = nid != 0
        ni = np.abs(nid[keep]) - 1
        for n, t, c in zip(ni, tag_ids[keep], counts[keep]):
            d = node_tags[n]
            d[t] = d.get(t, 0) + int(c)
        for d in node_tags:
            for t in [t for t, c in d.items() if c < MIN_NUM_MAPPED_TAG]:
                del d[t]
        return node_tags

    def get_common_tag(self, id1: int, id2: int, node_tags) -> int:
        """getCommonTagBetweenNodePair (scaffoldGraph.cpp:~500): sum of
        min counts over tags shared by both nodes."""
        d1 = node_tags[abs(id1) - 1]
        d2 = node_tags[abs(id2) - 1]
        if len(d1) > len(d2):
            d1, d2 = d2, d1
        return sum(min(c, d2[t]) for t, c in d1.items() if t in d2)

    def delete_erroneous_edge_num_tag_rate(self) -> int:
        """deleteErroneousEdgeNumTagRate (pairedDBG.cpp:4458-4499):
        among conflicting edge pairs, delete the side whose common-tag
        count is < 0.125 x the other side's."""
        RATE_THRESHOLD = 0.125
        node_tags = self._node_tag_counts()
        ids = []
        for ni, n in enumerate(self.node):
            for a in range(len(n.edges) - 1):
                for b in range(a + 1, len(n.edges)):
                    e1, e2 = n.edges[a], n.edges[b]
                    n1 = self.node[abs(e1.end) - 1]
                    n2 = self.node[abs(e2.end) - 1]
                    if not self._check_delete_edge(e1, e2, n1, n2):
                        continue
                    t1 = self.get_common_tag(ni + 1, e1.end, node_tags)
                    t2 = self.get_common_tag(ni + 1, e2.end, node_tags)
                    if t1 < RATE_THRESHOLD * t2:
                        ids.append((ni + 1, e1.end))
                    elif t2 < RATE_THRESHOLD * t1:
                        ids.append((ni + 1, e2.end))
        self.delete_edges(ids)
        return len(ids)

    def delete_erroneous_edge_num_tag_rate_iterative(self) -> int:
        if self.contig_tag is None:
            return 0
        LOG.info("removing erroneous edges using tags ...")
        total = 0
        while True:
            n = self.delete_erroneous_edge_num_tag_rate()
            LOG.counter("NUM_REMOVED_EDGES_BY_TAG", n)
            if n == 0:
                break
            total += n
        return total

    # ------------------------------------------------------------------
    # cross-structure resolution (solveSimpleCrossStructure,
    # pairedDBG.cpp:1543-1640 + 2405-2452)
    # ------------------------------------------------------------------
    def _oriented_parts(self, nid: int) -> list:
        n = self.node[abs(nid) - 1]
        if nid > 0:
            return list(n.contigs)
        L = n.length
        return [(-cid, L - ed, L - st) for cid, st, ed in reversed(n.contigs)]

    def _node_overlap_adjacency(self):
        """Node-level overlap neighbors from the contig overlap table:
        adj[signed node id] = right-end overlap successors (getOverlappedNode
        equivalent over current nodes).

        strict_dbg_overlap mirrors the reference's DBG_OVERLAP edge gate:
        getOverlappedNode only follows edges flagged DBG_OVERLAP
        (pairedDBG.cpp:1051-1059), and those edges exist only for overlap
        links whose overlap length equals minOverlap EXACTLY
        (storeGraphLinkFromOverlap's `gap == -minOverlap` test,
        pairedDBG.cpp:92; flag assignment at :613-614). The default (>=)
        is this rebuild's deliberately more permissive criterion — it
        recovers haplotype pairs the reference's gate leaves unpaired
        (parity/PARITY_phase_300000.json known_divergence)."""
        end_owner: dict[int, int] = {}
        left_owner: dict[int, int] = {}
        for ni, n in enumerate(self.node):
            if n.state & SC_DEL or not n.contigs:
                continue
            nid = ni + 1
            end_owner[n.contigs[-1][0]] = nid
            end_owner[-n.contigs[0][0]] = -nid
            left_owner[n.contigs[0][0]] = nid
            left_owner[-n.contigs[-1][0]] = -nid
        adj: dict[int, set] = {}
        strict = getattr(self, "strict_dbg_overlap", False)
        for (a, b), ov in self.overlap_table.items():
            if (ov != self.min_overlap) if strict else (ov < self.min_overlap):
                continue
            for x, y in ((a, b), (-b, -a)):
                n1 = end_owner.get(x)
                n2 = left_owner.get(y)
                if n1 is None or n2 is None or abs(n1) == abs(n2):
                    continue
                adj.setdefault(n1, set()).add(n2)
                adj.setdefault(-n2, set()).add(-n1)
        return adj

    def _num_link_between(self, id1: int, id2: int) -> int:
        """getNumLinkFromIDPair: PE links between the node pair (direction
        sign-insensitive; evidence only)."""
        return sum(e.num_link for e in self.node[abs(id1) - 1].edges
                   if abs(e.end) == abs(id2))

    def _score_between(self, id1: int, id2: int) -> int:
        """getScoreFromIDPair (pairedDBG.cpp:6140-6156): the long-read
        alignment score on the edge leaving id1 toward id2 with matching
        direction and relative strand."""
        d = 1 if id1 > 0 else -1
        strand = d * (1 if id2 > 0 else -1)
        for e in self.node[abs(id1) - 1].edges:
            if (abs(e.end) == abs(id2) and e.direction == d
                    and (1 if e.end > 0 else -1) == strand):
                return e.score
        return 0

    def _haplotype_evidence(self, id1: int, id2: int, resolution: str,
                            node_tags) -> int:
        if resolution == "score":
            return self._score_between(id1, id2)
        if node_tags is not None:
            return self.get_common_tag(id1, id2, node_tags)
        return self._num_link_between(id1, id2)

    def solve_simple_cross_structure(self, link_rate_threshold: float = 0.25,
                                     resolution: str = "link") -> int:
        """Split high-coverage cross nodes (2 overlap-neighbors each side,
        hetero-coverage externals) along the dominant haplotype pairing.
        The center node is DUPLICATED into both resolved chains."""
        from .phasing import HETERO_COVERAGE_THRESHOLD_FACTOR

        cov_threshold = (HETERO_COVERAGE_THRESHOLD_FACTOR
                         * self.average_coverage / 2.0)
        adj = self._node_overlap_adjacency()
        node_tags = (self._node_tag_counts() if resolution == "tag"
                     and self.contig_tag is not None else None)
        consumed = set()
        chains = []
        for ci, center in enumerate(self.node):
            if center.state & SC_DEL or not center.contigs:
                continue
            if self.node_coverage(center) < cov_threshold:
                continue
            rights = sorted(adj.get(ci + 1, ()))
            lefts = sorted(adj.get(-(ci + 1), ()))
            if len(rights) != 2 or len(lefts) != 2:
                continue
            # externals: lefts point away from center; flip to center-ward
            ext = [[-lefts[0], -lefts[1]], list(rights)]
            ids = {abs(x) for row in ext for x in row}
            if len(ids) != 4 or (ci + 1) in ids:
                continue
            # each external's center-ward side must reach only the center
            # (getOverlappedNode(external, sign) size check)
            ok = True
            for x in ext[0]:           # left: its right end faces center
                if len(adj.get(x, ())) >= 2:
                    ok = False
            for x in ext[1]:           # right: its left end faces center
                if len(adj.get(-x, ())) >= 2:
                    ok = False
            if not ok:
                continue
            covs = [self.node_coverage(self.node[abs(x) - 1])
                    for row in ext for x in row]
            if min(covs) > cov_threshold:
                continue
            if any(abs(x) - 1 in consumed for row in ext for x in row) \
                    or ci in consumed:
                continue
            s = [0, 0]   # s[1]: same-index pairing, s[0]: cross pairing
            for li in range(2):
                for ri in range(2):
                    s[li == ri] += self._haplotype_evidence(
                        ext[0][li], ext[1][ri], resolution, node_tags)
            if resolution in ("link", "tag") and max(s) < self.min_link:
                continue
            if link_rate_threshold * s[0] >= s[1]:
                cross = 1
            elif link_rate_threshold * s[1] >= s[0]:
                cross = 0
            else:
                continue
            for j in range(2):
                chains.append((ext[0][j], ci + 1, ext[1][(j + cross) % 2]))
            consumed.add(ci)
            consumed.update(abs(x) - 1 for row in ext for x in row)

        if not chains:
            return 0
        new_nodes = []
        for ni, n in enumerate(self.node):
            if ni not in consumed and not (n.state & SC_DEL) and n.contigs:
                new_nodes.append(list(n.contigs))
        for l, x, r in chains:
            parts = []
            pos = 0
            prev = None
            for nid in (l, x, r):
                op = self._oriented_parts(nid)
                if prev is not None:
                    pos -= self.scaffold_overlap(prev, nid)
                base = pos
                for cid, st, ed in op:
                    parts.append((cid, base + st, base + ed))
                pos = base + max(ed for _c, _s, ed in op)
                prev = nid
            new_nodes.append(parts)
        self._remake(new_nodes)
        LOG.counter("NUM_RESOLVED_CROSSES", len(chains) // 2)
        return len(chains) // 2

    def solve_simple_cross_structure_iterative(
            self, link_rate_threshold: float = 0.25,
            resolution: str = "link", rebuild=None) -> int:
        """Fixed-point loop (solveSimpleCrossStructureIterative,
        pairedDBG.cpp:2405-2452). `rebuild` re-makes PE edges after each
        round since _remake renumbers nodes (makeGraph in the reference)."""
        LOG.info("solving simple cross structures...")
        total = 0
        while True:
            n = self.solve_simple_cross_structure(link_rate_threshold,
                                                  resolution)
            if n == 0:
                break
            total += n
            if rebuild is not None:
                rebuild()
        return total

    def _unique_conflicting_edges(self, ni: int, direction: int):
        """getUniqueConflictingNode (pairedDBG.cpp:943-968): exactly one
        conflicting edge pair in `direction` with numLink >= minLink, else
        None. Returns [(signed end id, gap), (signed end id, gap)]."""
        nd = self.node[ni]
        found = None
        edges = [e for e in nd.edges
                 if e.direction == direction and e.num_link >= self.min_link]
        for a in range(len(edges) - 1):
            for b in range(a + 1, len(edges)):
                e1, e2 = edges[a], edges[b]
                if self._check_delete_edge(e1, e2,
                                           self.node[abs(e1.end) - 1],
                                           self.node[abs(e2.end) - 1]):
                    if found is not None:
                        return None
                    found = [(e1.end, e1.length), (e2.end, e2.length)]
        return found

    def _count_linked(self, ni: int, direction: int) -> int:
        """getLinkedNode size: linked neighbors of node ni in direction."""
        return sum(1 for e in self.node[ni].edges
                   if e.direction == direction
                   and e.num_link >= self.min_link)

    def solve_simple_gapped_cross_structure(
            self, link_rate_threshold: float = 0.25,
            resolution: str = "link") -> int:
        """solveSimpleGappedCrossStructure (pairedDBG.cpp:1641-1739):
        resolve a high-coverage center whose PE-link edges form exactly one
        conflicting pair on each side; the dominant haplotype pairing joins
        external-gap-center-gap-external into two gapped scaffolds (center
        duplicated; gaps retained, no overlap requirement)."""
        from .phasing import HETERO_COVERAGE_THRESHOLD_FACTOR

        # pairedDBG.cpp:1643: threshold on the FULL average coverage (the
        # overlap-based solver uses the halved hetero estimate instead)
        cov_threshold = (HETERO_COVERAGE_THRESHOLD_FACTOR
                         * self.average_coverage)
        node_tags = (self._node_tag_counts() if resolution == "tag"
                     and self.contig_tag is not None else None)
        consumed: set[int] = set()
        merges = []
        for ci, center in enumerate(self.node):
            if center.state & SC_DEL or not center.contigs:
                continue
            if self.node_coverage(center) < cov_threshold:
                continue
            if center.state & (DBG_PRIMARY_BUBBLE | DBG_SECONDARY_BUBBLE):
                continue
            ext = []
            for direction in (-1, 1):
                pair = self._unique_conflicting_edges(ci, direction)
                if pair is None:
                    break
                # externals must not branch on their far side
                # (getLinkedNode >= 3 check, pairedDBG.cpp:1668-1672)
                if any(self._count_linked(abs(eid) - 1,
                                          1 if eid > 0 else -1) >= 3
                       for eid, _g in pair):
                    break
                ext.append(pair)
            if len(ext) != 2:
                continue
            ids = {abs(eid) for pair in ext for eid, _g in pair}
            if len(ids) != 4 or (ci + 1) in ids:
                continue
            covs = [self.node_coverage(self.node[abs(eid) - 1])
                    for pair in ext for eid, _g in pair]
            if min(covs) > cov_threshold:
                continue
            if ci in consumed or any(abs(eid) - 1 in consumed
                                     for pair in ext for eid, _g in pair):
                continue
            s = [0, 0]
            for li in range(2):
                for ri in range(2):
                    s[li == ri] += self._haplotype_evidence(
                        ext[0][li][0], ext[1][ri][0], resolution, node_tags)
            if resolution in ("link", "tag") and max(s) < self.min_link:
                continue
            if link_rate_threshold * s[0] >= s[1]:
                cross = 1
            elif link_rate_threshold * s[1] >= s[0]:
                cross = 0
            else:
                continue
            for j in range(2):
                # a direction=-1 edge's end sits LEFT of center with its
                # stored sign as chain orientation; chain = L, center, R
                l_id, l_gap = ext[0][j]
                r_id, r_gap = ext[1][(j + cross) % 2]
                merges.append((l_id, l_gap, ci + 1, r_gap, r_id))
            consumed.add(ci)
            consumed.update(abs(eid) - 1 for pair in ext for eid, _g in pair)

        if not merges:
            return 0
        new_nodes = []
        for ni, n in enumerate(self.node):
            if ni not in consumed and not (n.state & SC_DEL) and n.contigs:
                new_nodes.append(list(n.contigs))
        for l_id, l_gap, c_id, r_gap, r_id in merges:
            parts = []
            pos = 0
            for nid, gap in ((l_id, 0), (c_id, l_gap), (r_id, r_gap)):
                pos += gap
                op = self._oriented_parts(nid)
                for cid, st, ed in op:
                    parts.append((cid, pos + st, pos + ed))
                pos += max(ed for _c, _s, ed in op)
            new_nodes.append(parts)
        self._remake(new_nodes)
        LOG.counter("NUM_RESOLVED_GAPPED_CROSSES", len(merges) // 2)
        return len(merges) // 2

    def join_unambiguous_node_pair_gapped(self) -> int:
        """joinUnambiguousNodePairGapped (pairedDBG.cpp:2517-2566): merge
        node pairs connected by a single mutually-unambiguous PE-link edge
        (one linked neighbor each way), keeping the estimated gap."""
        nxt: dict[int, tuple[int, int]] = {}
        for ni, nd in enumerate(self.node):
            if nd.state & SC_DEL:
                continue
            rights = [e for e in nd.edges
                      if e.direction == 1 and e.num_link >= self.min_link]
            if len(rights) != 1:
                continue
            e = rights[0]
            back_dir = -1 if e.end > 0 else 1
            back = [b for b in self.node[abs(e.end) - 1].edges
                    if b.direction == back_dir
                    and b.num_link >= self.min_link]
            if len(back) == 1 and abs(back[0].end) == ni + 1:
                nxt[ni + 1] = (e.end, max(e.length, 1))
        # disjoint pair merges only (the reference joins pairs per pass
        # and its *Iterative driver re-runs after a graph rebuild)
        used = np.zeros(len(self.node), dtype=bool)
        chains = []
        for a, (b, g) in nxt.items():
            if used[a - 1] or used[abs(b) - 1] or abs(b) == a:
                continue
            used[a - 1] = True
            used[abs(b) - 1] = True
            chains.append([(a, 0), (b, g)])
        if not chains:
            return 0
        new_nodes = []
        for ni, n in enumerate(self.node):
            if not used[ni] and not (n.state & SC_DEL) and n.contigs:
                new_nodes.append(list(n.contigs))
        for chain in chains:
            parts = []
            pos = 0
            for nid, gap in chain:
                pos += gap
                op = self._oriented_parts(nid)
                for cid, st, ed in op:
                    parts.append((cid, pos + st, pos + ed))
                pos += max(ed for _c, _s, ed in op)
            new_nodes.append(parts)
        self._remake(new_nodes)
        LOG.counter("NUM_JOINED_GAPPED_PAIRS", len(chains))
        return len(chains)

    # ------------------------------------------------------------------
    # shared node-splitting tail of the reference's divide*/trim* passes
    # (e.g. pairedDBG.cpp:2754-2790): split nodes at breakpoint flags,
    # keep a piece only if it contains a contig not yet emitted
    # (uniqueFlag), remake
    # ------------------------------------------------------------------
    def split_nodes_at_breakpoints(self, bp: list[np.ndarray],
                                   extra_nodes: list | None = None) -> None:
        num_used = np.zeros(self.num_contig, dtype=np.int64)
        new_nodes: list[list] = []
        for ni, n in enumerate(self.node):
            if n.state & SC_DEL or not n.contigs:
                continue
            contigs = n.contigs
            flags = bp[ni]
            i = 0
            while i < len(contigs):
                j = i
                while not flags[i + 1]:
                    i += 1
                i += 1
                piece = contigs[j:i]
                if any(num_used[abs(cid) - 1] == 0 for cid, _s, _e in piece):
                    base = piece[0][1]
                    new_nodes.append([(cid, st - base, ed - base)
                                      for cid, st, ed in piece])
                    for cid, _s, _e in piece:
                        num_used[abs(cid) - 1] += 1
        if extra_nodes:
            new_nodes.extend(extra_nodes)
        self._remake(new_nodes)

    def _blank_breakpoints(self, ends_flagged: bool = True) -> list[np.ndarray]:
        bp = [np.zeros(len(n.contigs) + 1, dtype=bool) for n in self.node]
        for f in bp:
            if ends_flagged:
                f[0] = True
            f[-1] = True
        return bp

    def trim_sparse_end(self) -> None:
        """trimSparseEnd (pairedDBG.cpp:3745-3810): cut off a terminal
        contig whose gap to the rest exceeds its own length."""
        LOG.info("trimming sparse ends of scaffolds...")
        bp = self._blank_breakpoints(ends_flagged=False)
        for ni, n in enumerate(self.node):
            c = n.contigs
            if len(c) > 1:
                if c[1][1] - c[0][2] > c[0][2] - c[0][1]:
                    bp[ni][1] = True
                if c[-1][1] - c[-2][2] > c[-1][2] - c[-1][1]:
                    bp[ni][len(c) - 2] = True
        self.split_nodes_at_breakpoints(bp)

    def divide_gapped_node(self, min_gap_size: int) -> None:
        """divideGappedNode (pairedDBG.cpp:3678-3744): split scaffolds at
        gaps longer than min_gap_size."""
        LOG.info("dividing scaffolds at gaps...")
        bp = self._blank_breakpoints(ends_flagged=False)
        for ni, n in enumerate(self.node):
            c = n.contigs
            for i in range(1, len(c)):
                if c[i][1] - c[i - 1][2] > min_gap_size:
                    bp[ni][i] = True
        self.split_nodes_at_breakpoints(bp)

    def delete_long_edge(self, max_edge_length: int) -> None:
        """deleteLongEdge (pairedDBG.cpp:4437-4456): drop edges whose
        estimated gap exceeds max_edge_length."""
        ids = []
        for ni, n in enumerate(self.node):
            for e in n.edges:
                if e.length > max_edge_length:
                    ids.append((ni + 1, e.end))
        self.delete_edges(ids)

    # ------------------------------------------------------------------
    # all-library pooled graph (makeGraphAllLibraries, pairedDBG.cpp:674)
    # ------------------------------------------------------------------
    def make_graph_all_libraries(self, sources: list, read_records=None) -> None:
        """Build edges pooling PE links of every library in `sources`
        [(lib, pairs), ...] plus long-read links (with scores). Matches
        makeGraphAllLibraries' edge merge: numLink summed across
        libraries, gap link-weighted, scores from the long-read channel."""
        LOG.info("constructing graph using all libraries simultaneously")
        keep_lib, keep_pairs = self.lib, self.pairs
        acc: dict[tuple, list] = {}

        def fold(links, score_col: bool):
            if len(links) == 0:
                return
            order = np.lexsort((links[:, 4], links[:, 2], links[:, 0]))
            links = links[order]
            keys = links[:, [0, 2]]
            new_grp = np.ones(len(links), dtype=bool)
            new_grp[1:] = (keys[1:] != keys[:-1]).any(axis=1)
            starts = np.nonzero(new_grp)[0]
            ends = np.append(starts[1:], len(links))
            for s, e in zip(starts, ends):
                id1, id2 = int(links[s, 0]), int(links[s, 2])
                ent = acc.setdefault((id1, id2), [0, 0, 0])
                ent[0] += int(e - s)                  # numLink
                ent[1] += int(links[s:e, 4].sum())    # gap * links
                if score_col:
                    ent[2] += int(links[s:e, 5].sum())

        for lib, pairs in sources:
            self.lib, self.pairs = lib, pairs
            fold(self.store_links(), False)
        if read_records is not None:
            fold(self.store_links_long(read_records), True)
        self.lib, self.pairs = keep_lib, keep_pairs

        for n in self.node:
            n.edges = []
        for (id1, id2), (num_link, gap_sum, score) in acc.items():
            if num_link < self.min_link:
                continue
            gap = int(math.floor(gap_sum / num_link + 0.5))
            i, j = abs(id1) - 1, abs(id2) - 1
            d1 = 1 if id1 > 0 else -1
            d2 = 1 if -id2 > 0 else -1
            end1 = (j + 1) if id1 * id2 > 0 else -(j + 1)
            end2 = (i + 1) if id1 * id2 > 0 else -(i + 1)
            self.node[i].edges.append(GraphEdge(d1, end1, gap, num_link,
                                                None, score))
            self.node[j].edges.append(GraphEdge(d2, end2, gap, num_link,
                                                None, score))
        for n in self.node:
            n.edges.sort(key=lambda e: (e.direction, e.end))

    def solve_cross_all_libraries_iterative(self, resolution: str,
                                            sources: list, read_records=None,
                                            gapped: bool = False) -> int:
        """solveSimpleCrossStructureAllLibrariesIterative /
        solveSimpleGappedCrossStructureAllLibrariesIterative
        (pairedDBG.cpp:2433-2460,2475-2510): rebuild the pooled graph each
        round, resolve crosses, stop at fixed point or 5 iterations."""
        total = 0
        for _ in range(MAX_ITERATION_OF_CROSS_SOLUTION):
            # the reference builds the pooled graph at minLink=1 and gates
            # only inside the solver (setMinLink dance, pairedDBG.cpp:2440)
            cur = self.min_link
            self.min_link = 1
            self.make_graph_all_libraries(sources, read_records)
            self.min_link = cur
            if gapped:
                thr = (CROSS_SCORE_RATE_THRESHOLD if resolution == "score"
                       else CROSS_LINK_RATE_THRESHOLD)
                n = self.solve_simple_gapped_cross_structure(thr, resolution)
            else:
                n = self.solve_simple_cross_structure(
                    CROSS_LINK_RATE_THRESHOLD, resolution)
            total += n
            if n == 0:
                break
        return total

    def join_unambiguous_node_pair_gapped_iterative_all_libraries(
            self, sources: list, read_records=None) -> int:
        """joinUnambiguousNodePairGappedIterativeAllLibraries
        (pairedDBG.cpp:2590-2612)."""
        total = 0
        while True:
            cur = self.min_link
            self.min_link = 1
            self.make_graph_all_libraries(sources, read_records)
            self.min_link = cur
            n = self.join_unambiguous_node_pair_gapped()
            total += n
            if n == 0:
                break
        return total

    def delete_repeat_edge(self) -> None:
        """deleteRepeatEdge (scaffoldGraph.cpp:1148-1190): when two
        conflicting edges both hit the same member contig, zero that
        contig's contribution and drop it from the scaffold."""
        for ni, n in enumerate(self.node):
            if len(n.contigs) == 1:
                continue
            for a in range(len(n.edges) - 1):
                for b in range(a + 1, len(n.edges)):
                    e1, e2 = n.edges[a], n.edges[b]
                    n1 = self.node[abs(e1.end) - 1]
                    n2 = self.node[abs(e2.end) - 1]
                    if not self._check_delete_edge(e1, e2, n1, n2):
                        continue
                    for m in range(len(n.contigs)):
                        if (e1.breakdown is None or e2.breakdown is None
                                or e1.breakdown[m] < self.min_link
                                or e2.breakdown[m] < self.min_link):
                            continue
                        for e in n.edges:
                            if e.breakdown is not None:
                                e.num_link -= int(e.breakdown[m])
                                e.breakdown[m] = 0
                        self.contig_pos_id[abs(n.contigs[m][0]) - 1] = 0
        ids = []
        for ni, n in enumerate(self.node):
            for e in n.edges:
                if e.num_link < self.min_link:
                    ids.append((ni + 1, e.end))
        self.delete_edges(ids)

    def delete_edge_from_different_previous_parent(self) -> int:
        """deleteEdgeFromDifferentPreviousParent (pairedDBG.cpp:4270-4315):
        zero breakdown contributions of contigs whose previous parent node
        matches a contig in the linked node (the pair was divided apart
        before), then drop edges that fall below min_link."""
        if not self.contig_prev_parent.any():
            return 0
        for ni, n1 in enumerate(self.node):
            parents1 = [self.contig_prev_parent[abs(c[0]) - 1]
                        for c in n1.contigs]
            for e in n1.edges:
                if e.breakdown is None:
                    continue
                n2 = self.node[abs(e.end) - 1]
                parents2 = {int(self.contig_prev_parent[abs(c[0]) - 1])
                            for c in n2.contigs
                            if self.contig_prev_parent[abs(c[0]) - 1] != 0}
                for m, p in enumerate(parents1):
                    if p == 0:
                        break
                    if int(p) in parents2:
                        e.num_link -= int(e.breakdown[m])
                        e.breakdown[m] = 0
        ids = []
        for ni, n in enumerate(self.node):
            for e in n.edges:
                if e.num_link < self.min_link:
                    ids.append((ni + 1, e.end))
        self.delete_edges(ids)
        if ids:
            LOG.counter("NUM_SPLIT_LINK(DIVISION_AWARE)", len(ids))
        return len(ids)

    def detect_repeat(self, average_coverage: float) -> None:
        """detectRepeat (scaffoldGraph.cpp:1194-1231)."""
        threshold = average_coverage * 1.5
        for n in self.node:
            if len(n.contigs) == 1 and self.node_coverage(n) > threshold:
                n.state |= SC_REP
                continue
            done = False
            for a in range(len(n.edges) - 1):
                if done:
                    break
                for b in range(a + 1, len(n.edges)):
                    e1, e2 = n.edges[a], n.edges[b]
                    if e1.direction * e2.direction < 0:
                        continue
                    n1 = self.node[abs(e1.end) - 1]
                    if e1.length + n1.length <= e2.length:
                        continue
                    n2 = self.node[abs(e2.end) - 1]
                    if e2.length + n2.length <= e1.length:
                        continue
                    if e1.direction > 0:
                        a1, a2 = e1.end, e2.end
                    else:
                        a1, a2 = e2.end, e1.end
                    if (abs(e1.length + n1.length - e2.length)
                            <= self.tolerence + self.scaffold_overlap(a1, a2)
                            or abs(e2.length + n2.length - e1.length)
                            <= self.tolerence + self.scaffold_overlap(a2, a1)):
                        continue
                    n.state |= SC_REP
                    done = True
                    break

    # ------------------------------------------------------------------
    # scaffolding (makeScaffold + remake)
    # ------------------------------------------------------------------
    def make_scaffold(self) -> None:
        LOG.info("scaffolding...")
        new_nodes: list[list] = []  # each: list of (cid, start, end)
        for i in range(len(self.node)):
            if self.node[i].state & (SC_INC | SC_REP | SC_DEL):
                continue
            include = [[i + 1, 0, self.node[i].length, 0]]  # id, start, end, dist
            self.node[i].state |= SC_INC
            candidate = []

            def push_candidates(lay_id, lay_start, lay_end, dist, node_ref):
                for e in node_ref.edges:
                    t = abs(e.end) - 1
                    if (self.node[t].state & SC_INC) and not (self.node[t].state & SC_REP):
                        continue
                    if (lay_id > 0) == (e.direction > 0):
                        st = lay_end + e.length
                        en = st + self.node[t].length
                    else:
                        en = lay_start - e.length
                        st = en - self.node[t].length
                    cid = e.end if lay_id > 0 else -e.end
                    candidate.append([cid, st, en, dist + 1, e.num_link])

            push_candidates(i + 1, 0, self.node[i].length, 0, self.node[i])

            while candidate:
                best = 0
                for j in range(1, len(candidate)):
                    if (candidate[j][3] < candidate[best][3]
                        or (candidate[j][3] == candidate[best][3]
                            and abs(candidate[j][1]) < abs(candidate[best][1]))):
                        best = j
                cand = candidate.pop(best)
                t = abs(cand[0]) - 1
                if (self.node[t].state & SC_INC) and not (self.node[t].state & SC_REP):
                    continue
                ok = True
                for inc in include:
                    tol = min(self.tolerence,
                              min(cand[2] - cand[1], inc[2] - inc[1]) // 2)
                    if (cand[2] <= inc[1] or cand[1] >= inc[2]
                            or abs(cand[1] - inc[2]) <= tol
                            + self.scaffold_overlap(inc[0], cand[0])
                            or abs(cand[2] - inc[1]) <= tol
                            + self.scaffold_overlap(cand[0], inc[0])):
                        continue
                    ok = False
                    break
                if not ok:
                    continue
                include.append(cand)
                nn = self.node[t]
                if not (nn.state & SC_REP):
                    push_candidates(cand[0], cand[1], cand[2], cand[3], nn)
                    nn.state |= SC_INC

            include.sort(key=lambda x: (x[1] + x[2]))
            # strip repeat nodes at both ends (makeScaffold :1519-1526)
            lo, hi = 0, len(include)
            while lo < hi and self.node[abs(include[lo][0]) - 1].state & SC_REP:
                lo += 1
            while hi > lo and self.node[abs(include[hi - 1][0]) - 1].state & SC_REP:
                hi -= 1
            include = include[lo:hi]
            if not include:
                continue
            min_start = include[0][1]
            parts = []
            prev = None
            shift = 0
            for lay in include:
                lay[1] += shift - min_start
                lay[2] += shift - min_start
                t = abs(lay[0]) - 1
                self.node[t].state |= SC_INC
                if prev is not None and lay[1] != 0:
                    ov = self.scaffold_overlap(prev[0], lay[0])
                    if ov > 0 and ov + lay[1] - prev[2] <= self.tolerence:
                        adj = prev[2] - lay[1] - ov
                        lay[1] += adj
                        lay[2] += adj
                        shift += adj
                nref = self.node[t]
                if lay[0] > 0:
                    for cid, cst, ced in nref.contigs:
                        parts.append((cid, lay[1] + cst, lay[1] + ced))
                else:
                    for cid, cst, ced in reversed(nref.contigs):
                        parts.append((-cid, lay[1] + nref.length - ced,
                                      lay[1] + nref.length - cst))
                prev = lay
            new_nodes.append(parts)

        # repeat nodes: unplaced ones stay as their own scaffolds
        for i, n in enumerate(self.node):
            if not (n.state & SC_REP):
                continue
            if n.state & SC_INC:
                for cid, _s, _e in n.contigs:
                    self.contig_pos_id[abs(cid) - 1] = 0
            else:
                new_nodes.append(list(n.contigs))
        self._remake(new_nodes)

    def _remake(self, new_nodes: list[list]) -> None:
        """remake (scaffoldGraph.cpp:1579-1640): rebuild node/contig tables."""
        self.node = []
        self.contig_pos_id = np.zeros(self.num_contig, dtype=np.int64)
        self.contig_pos_off = np.zeros(self.num_contig, dtype=np.int64)
        for parts in new_nodes:
            parts = sorted(parts, key=lambda p: (p[1], p[2]))
            base = parts[0][1]
            parts = [(cid, st - base, ed - base) for cid, st, ed in parts]
            length = max(ed for _c, _s, ed in parts)
            nid = len(self.node) + 1
            self.node.append(GraphNode(length=length, contigs=parts))
            for k, (cid, _s, _e) in enumerate(parts):
                ci = abs(cid) - 1
                if self.contig_pos_id[ci] != 0:
                    self.contig_pos_id[ci] = 0  # contig in 2+ scaffolds: exclude
                else:
                    self.contig_pos_id[ci] = nid if cid > 0 else -nid
                    self.contig_pos_off[ci] = k
        LOG.counter("NUM_SCAFFOLD", len(self.node))

    # ------------------------------------------------------------------
    # output (loadResultSeq, pairedDBG.cpp:2048-2230)
    # ------------------------------------------------------------------
    def load_result_seq(self, min_seq_length: int, read_length: int,
                        contig_max_k: int, trim_overlap: bool = False
                        ) -> list[ResultSeq]:
        default_min_overlap = self.min_overlap
        self.min_overlap = MIN_OVERLAP_TO_JOIN
        results: list[ResultSeq] = []
        num_out = 0
        for ni, n in enumerate(self.node):
            if n.state & SC_DEL or not n.contigs:
                continue
            if all(self.contig_pos_id[abs(c[0]) - 1] == 0 for c in n.contigs):
                continue
            nc = len(n.contigs)
            left_cut = [0] * nc
            right_cut = [0] * nc
            gap = [0] * nc
            for k in range(nc - 1):
                cid, cst, ced = n.contigs[k]
                nid, nst, ned = n.contigs[k + 1]
                ov = self.get_overlap(cid, nid)
                if ced > nst:
                    if ov > self.min_overlap:
                        left_cut[k + 1] = ov
                    else:
                        gap[k] = MIN_GAP_LENGTH
                elif nst - ced <= self.tolerence:
                    if ov > self.min_overlap:
                        left_cut[k + 1] = ov
                    else:
                        gap[k] = nst - ced
                else:
                    gap[k] = nst - ced
            total = 0
            for k in range(nc):
                ci = abs(n.contigs[k][0]) - 1
                total += len(self.contig[ci]) - left_cut[k] - right_cut[k] + gap[k]
            if total < min_seq_length:
                continue
            segs = []
            for k in range(nc):
                cid = n.contigs[k][0]
                c = self.contig[abs(cid) - 1]
                if cid > 0:
                    seg = c[left_cut[k]: len(c) - right_cut[k]]
                else:
                    seg = _rc_np(c)[left_cut[k]: len(c) - right_cut[k]]
                segs.append(seg)
                if gap[k] > 0:
                    segs.append(np.full(gap[k], 4, np.uint8))
            seq = np.concatenate(segs) if segs else np.zeros(0, np.uint8)
            num_out += 1
            cov = int(self.node_coverage(n) + 0.5)
            name = (f"scaffold{num_out}_len{len(seq)}_cov{cov}"
                    f"_read{read_length}_maxK{contig_max_k}")
            comp_lines = []
            pos = 0
            for k in range(nc):
                cid = n.contigs[k][0]
                ci = abs(cid) - 1
                st = pos
                ed = st + len(self.contig[ci]) - left_cut[k] - right_cut[k]
                strand = "+" if cid > 0 else "-"
                comp_lines.append(f"{name}\t{st}\t{ed}\t{self.names[ci]}\t0\t{strand}")
                pos = ed + gap[k]
            results.append(ResultSeq(seq=seq, name=name,
                                     component="\n".join(comp_lines) + "\n",
                                     node_index=ni))
        self.min_overlap = default_min_overlap
        return results


def mark_redundant_result_seq(results: list[ResultSeq],
                              contig_max_k: int = 32) -> None:
    """markRedundantResultSeq (pairedDBG.cpp:6266-6340): flag sequences
    exactly contained (either strand) in a longer sequence — the reference
    is exact-substring matching accelerated by a shared-prefix index
    (prefixLength = contigMaxK capped to the shortest sequence;
    std::search at each prefix hit), reproduced here.
    """
    live = [i for i, r in enumerate(results) if len(r.seq)]
    if not live:
        return
    prefix_len = min(contig_max_k, min(len(results[i].seq) for i in live))
    strs = ["".join("ACGTN"[b] for b in r.seq) for r in results]
    prefix_to_idx: dict[str, list[int]] = {}
    for i in live:
        prefix_to_idx.setdefault(strs[i][:prefix_len], []).append(i)

    comp = str.maketrans("ACGTN", "TGCAN")
    for i in live:
        for strand in (0, 1):
            target = strs[i] if strand == 0 else \
                strs[i].translate(comp)[::-1]
            for base in range(len(target) - prefix_len + 1):
                for j in prefix_to_idx.get(target[base: base + prefix_len],
                                           ()):
                    if j == i or results[j].redundant:
                        continue
                    sj = strs[j]
                    if not (len(target) > len(sj)
                            or (len(target) == len(sj) and i < j)):
                        continue
                    if (len(target) - base >= len(sj)
                            and target[base: base + len(sj)] == sj):
                        results[j].redundant = True


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _rc_np(codes: np.ndarray) -> np.ndarray:
    out = codes[::-1].copy()
    m = out < 4
    out[m] = 3 - out[m]
    return out


def _codes_to_key(codes: np.ndarray, W: int) -> np.ndarray:
    """Pack base codes into the (W,) uint32 big-endian key layout."""
    val = 0
    for c in codes:
        val = (val << 2) | int(c & 3)
    out = np.zeros(W, dtype=np.uint64)
    for i in range(W - 1, -1, -1):
        out[i] = val & 0xFFFFFFFF
        val >>= 32
    return out


def _pack64(keys: np.ndarray) -> np.ndarray:
    """(N, W<=2) uint32 keys -> sortable uint64 scalars."""
    k = keys.astype(np.uint64)
    if keys.shape[1] == 1:
        return k[:, 0]
    return (k[:, 0] << np.uint64(32)) | k[:, 1]


def _pack64_row(key: np.ndarray) -> np.uint64:
    k = key.astype(np.uint64)
    if len(k) == 1:
        return k[0]
    return (k[0] << np.uint64(32)) | k[1]


def dump_all_edges(graph: ScaffoldGraph, path: str) -> None:
    """dumpAllEdges (scaffoldGraph.h:358, .cpp dumpAllEdges): TSV of every
    forward edge with node lengths, repeat states, component contig-name
    runs, edge length/link count/score — the graph debugging artifact."""
    def component(nd: GraphNode, flip: bool) -> str:
        parts = nd.contigs if not flip else \
            [(-cid, st, ed) for cid, st, ed in reversed(nd.contigs)]
        return ";".join(("-" if cid < 0 else "")
                        + graph.names[abs(cid) - 1]
                        for cid, _s, _e in parts)

    with open(path, "w") as out:
        out.write("#node1_ID\tnode1_len\tnode1_state\tnode1_component\t"
                  "edge_len\tedge_num_links\tnode2_ID\tnode2_len\t"
                  "node2_state\tnode2_component\tscore\n")
        for ni, nd in enumerate(graph.node):
            for e in nd.edges:
                if e.direction <= 0:
                    continue
                n2 = graph.node[abs(e.end) - 1]
                out.write("\t".join([
                    str(ni + 1), str(nd.length),
                    "rep" if nd.state & SC_REP else "non_rep",
                    component(nd, False),
                    str(e.length), str(e.num_link), str(e.end),
                    str(n2.length),
                    "rep" if n2.state & SC_REP else "non_rep",
                    component(n2, e.end < 0),
                    str(e.score)]) + "\n")
