"""Hetero/bubble machinery for scaffold graphs.

Re-design of the heterozygosity-handling set shared by ScaffoldGraph and
PairedDBG:

- node classification            <- classifyNode (scaffoldGraph.cpp:403-421)
- bubble->contig mapping         <- HeteroMapper::mergeBubble
                                    (mapper.cpp:215-313)
- local layout (BFS by hops)     <- layoutNodes (scaffoldGraph.cpp:2020-2138)
- layout -> sequence             <- layout2seq (scaffoldGraph.cpp:2140-2214)
- banded scaffold alignment      <- alignScaffold (scaffoldGraph.cpp:2216-2277)
- layout-alignment bubble crush  <- crushBubble (scaffoldGraph.cpp:1888-2013)
- hetero bubble crush            <- crushHeteroBubble (scaffoldGraph.cpp:
                                    1638-1745; PairedDBG variant
                                    pairedDBG.cpp:1889-1994)
- hetero edge removal            <- deleteHeteroEdge (scaffoldGraph.cpp:
                                    2305-2352; PairedDBG variant
                                    pairedDBG.cpp:1995-2047)
- contained-hetero removal       <- removeHeteroOverlap
                                    (scaffoldGraph.cpp:2427-2510)
- DBG bubble extraction          <- getOverlappedBubbleNodeIndex
                                    (pairedDBG.cpp:866-913),
                                    calculateHeteroCoverage (:1092-1166),
                                    markBubbleHeteroNode (:1082-1090),
                                    extractDBGBubbleInformation (:1213-1225)
- simple DBG bubble crush        <- crushSimpleDBGBubble (pairedDBG.cpp:
                                    1226-1303)
- opposite-bubble contig ids     <- getOverlappedBubbleNodePairID (:914-...),
                                    setOppositeBubbleContigIDOverlapped
                                    (:2613-2660)
- node-level bubble pairing      <- outputResultSeqWithBubble pairFlag scan
                                    (pairedDBG.cpp:2328-2341)

The graphs are small (thousands of nodes) so this is host-side
Python/numpy per SURVEY §7.5; the banded edit distance runs columnar numpy
over anti-diagonal bands.

Port copy of platanus_b_tpu/models/hetero.py: the reference's text, its
relative imports resolving to the port's modules (scaffold, log).
No other change.
"""

from __future__ import annotations

import numpy as np

from ..utils.log import LOG
from .scaffold import (DBG_HETERO, DBG_SECONDARY_BUBBLE,
                       HETERO_COVERAGE_THRESHOLD_FACTOR, SC_DEL, SC_INC,
                       SC_REP, ScaffoldGraph)

# scaffoldGraph.cpp:45-47
MAX_HOMO_RATE = 1.5
MAX_HETERO_RATE = 0.75
MAX_OVERLAP_IDENTITY_DIFF = 0.05


# ---------------------------------------------------------------------------
# node classification & bubble mapping
# ---------------------------------------------------------------------------

def classify_node(graph: ScaffoldGraph) -> None:
    """classifyNode (scaffoldGraph.cpp:403-421): a node is homozygous if it
    carries >= 1 mapped bubble or its coverage >= the average."""
    min_homo_cov = int(graph.average_coverage * 1.0 + 0.5)
    for n in graph.node:
        bubble = 0
        for cid, _s, _e in n.contigs:
            ci = abs(cid) - 1
            if graph.contig_pos_id[ci] != 0:
                bubble += int(graph.num_bubble[ci])
        n.is_homo = bubble >= 1 or graph.node_coverage(n) >= min_homo_cov


def merge_bubble(graph: ScaffoldGraph, bubble_seqs: list[np.ndarray],
                 key_length: int = 32, seed_length: int = 32) -> np.ndarray:
    """HeteroMapper::mergeBubble (mapper.cpp:215-313): map each crushed
    bubble's two end seeds onto the contigs with maximal exact extension;
    when both ends land uniquely on the same contig, record a bubble at the
    midpoint. Returns bubble positions (signed contig id per bubble, 0 =
    unmapped) and increments graph.num_bubble (scaffoldGraph.cpp:397)."""
    # 32-mer exact lookup over all contigs (host dict — bubble counts are
    # small; the heavy read mapping stays on device in models.mapper)
    table: dict[int, list] = {}
    for ci, c in enumerate(graph.contig):
        L = len(c)
        if L < key_length:
            continue
        valid = c < 4
        keys = _rolling_keys(c, key_length)
        ok = np.lib.stride_tricks.sliding_window_view(valid, key_length).all(1)
        for off in np.nonzero(ok)[0]:
            table.setdefault(int(keys[off]), []).append((ci + 1, int(off)))

    positions = np.zeros(len(bubble_seqs), dtype=np.int64)
    for bi, seq in enumerate(bubble_seqs):
        if len(seq) < 2 * key_length:
            continue
        left = _map_end(graph, table, seq, key_length, seed_length,
                        left=True)
        if left is None:
            continue
        right = _map_end(graph, table, seq, key_length, seed_length,
                         left=False)
        if right is None or right[0] != left[0]:
            continue
        positions[bi] = left[0]
        ci = abs(left[0]) - 1
        graph.num_bubble[ci] += 1
    LOG.counter("NUM_MAPPED_BUBBLES", int((positions != 0).sum()))
    return positions


def _rolling_keys(codes: np.ndarray, k: int) -> np.ndarray:
    win = np.lib.stride_tricks.sliding_window_view(
        np.where(codes < 4, codes, 0).astype(np.uint64), k)
    shifts = (np.uint64(2) * np.arange(k - 1, -1, -1, dtype=np.uint64))
    return (win << shifts).sum(axis=1, dtype=np.uint64)


def _map_end(graph, table, seq, key_length, seed_length, left: bool):
    """One end of mergeBubble: seed lookup + maximal exact extension into
    the bubble; unique-max wins (ties -> unmapped)."""
    if left:
        probe = seq[:key_length]
    else:
        probe = seq[-key_length:]
    if (probe >= 4).any():
        return None
    key = int(_rolling_keys(probe, key_length)[0])
    rkey = int(_rolling_keys(_rc(probe), key_length)[0])
    best_len, best, tie = 0, None, False
    for (cid, off), rev in [(h, False) for h in table.get(key, [])] + \
                           [(h, True) for h in table.get(rkey, [])]:
        c = graph.contig[cid - 1]
        if left:
            ext = seq[key_length:] if not rev else _rc(seq[key_length:])
            if not rev:
                avail = c[off + key_length: off + key_length + len(ext)]
            else:
                lo = max(off - len(ext), 0)
                avail = c[lo: off][::-1] if off > 0 else c[:0]
                ext = ext[: len(avail)]
            m = _match_len(avail, ext)
            j = key_length + m
        else:
            ext = seq[:-key_length][::-1] if not rev \
                else _rc(seq[:-key_length][::-1])
            if not rev:
                lo = max(off - len(ext), 0)
                avail = c[lo: off][::-1] if off > 0 else c[:0]
                ext = ext[: len(avail)]
            else:
                avail = c[off + key_length: off + key_length + len(ext)]
            m = _match_len(avail, ext)
            j = key_length + m
        if j > best_len:
            best_len, tie = j, False
            best = (cid if not rev else -cid, off)
        elif j == best_len:
            tie = True
    if best_len < seed_length or tie or best is None:
        return None
    return best


def _match_len(a: np.ndarray, b: np.ndarray) -> int:
    n = min(len(a), len(b))
    if n == 0:
        return 0
    neq = a[:n] != b[:n]
    idx = np.nonzero(neq)[0]
    return int(idx[0]) if len(idx) else n


def _rc(codes: np.ndarray) -> np.ndarray:
    out = codes[::-1].copy()
    m = out < 4
    out[m] = 3 - out[m]
    return out


# ---------------------------------------------------------------------------
# layout machinery
# ---------------------------------------------------------------------------

def layout_nodes(graph: ScaffoldGraph, start_index: int) -> list[list]:
    """layoutNodes (scaffoldGraph.cpp:2020-2138): BFS layout around one
    node, nearest-hop first (ties by smaller start), with the same
    conflict test as makeScaffold. `start_index` is the 0-based node index.
    Returns [[signed id, start, end, dist], ...] sorted by position,
    normalized to start 0 and de-overlapped."""
    ni = start_index
    start_node = graph.node[ni]
    ret = [[ni + 1, 0, start_node.length, 0]]
    start_node.state |= SC_INC
    work: list[list] = []

    def push(from_id, from_start, from_end, dist, nd):
        for e in nd.edges:
            t = abs(e.end) - 1
            if (graph.node[t].state & SC_INC) \
                    and not (graph.node[t].state & SC_REP):
                continue
            if from_id * e.direction > 0:
                st = from_end + e.length
                en = st + graph.node[t].length
            else:
                en = from_start - e.length
                st = en - graph.node[t].length
            cid = e.end if from_id > 0 else -e.end
            work.append([cid, st, en, dist + 1])

    push(ni + 1, 0, start_node.length, 0, start_node)
    while work:
        best = 0
        for i in range(1, len(work)):
            if (work[i][3] < work[best][3]
                    or (work[i][3] == work[best][3]
                        and work[i][1] < work[best][1])):
                best = i
        cand = work.pop(best)
        t = abs(cand[0]) - 1
        if (graph.node[t].state & SC_INC) \
                and not (graph.node[t].state & SC_REP):
            continue
        ok = True
        for r in ret:
            if (cand[2] <= r[1] or cand[1] >= r[2]
                    or abs(cand[1] - r[2]) <= graph.tolerence
                    + graph.scaffold_overlap(r[0], cand[0])
                    or abs(cand[2] - r[1]) <= graph.tolerence
                    + graph.scaffold_overlap(cand[0], r[0])):
                continue
            ok = False
            break
        if not ok:
            continue
        ret.append(cand)
        nd = graph.node[t]
        if not (nd.state & SC_REP):
            push(cand[0], cand[1], cand[2], cand[3], nd)
            nd.state |= SC_INC

    ret.sort(key=lambda r: (r[1], r[2]))
    base = ret[0][1]
    for r in ret:
        graph.node[abs(r[0]) - 1].state &= ~SC_INC
        r[1] -= base
        r[2] -= base
    # de-overlap pass (scaffoldGraph.cpp:2110-2131)
    for i in range(1, len(ret)):
        if ret[i][1] == 0:
            continue
        ov = graph.scaffold_overlap(ret[i - 1][0], ret[i][0])
        if ov + ret[i][1] - ret[i - 1][2] <= graph.tolerence:
            shift = ret[i - 1][2] - ret[i][1] - ov
        elif ret[i][1] < ret[i - 1][2]:
            shift = ret[i - 1][2] - ret[i][1] + 1
        else:
            continue
        for j in range(i, len(ret)):
            ret[j][1] += shift
            ret[j][2] += shift
    return ret


def layout2seq(graph: ScaffoldGraph, layout: list, start: int,
               n: int) -> np.ndarray:
    """layout2seq (scaffoldGraph.cpp:2140-2214): concatenate the layout
    run's node sequences, joining on computed offsets with N (code 4)
    fill for gaps."""
    out: list[np.ndarray] = []
    pos = 0  # bases emitted so far correspond to layout coordinates
    for i in range(n):
        lay = layout[start + i]
        nd = graph.node[abs(lay[0]) - 1]
        parts = nd.contigs if lay[0] > 0 else \
            [(-cid, nd.length - ed, nd.length - st)
             for cid, st, ed in reversed(nd.contigs)]
        for j, (cid, cst, ced) in enumerate(parts):
            if i == 0 and j == 0:
                k = 0
            elif j == 0:
                k = layout[start + i - 1][2] - lay[1]
            else:
                k = parts[j - 1][2] - cst
            if k < 0:
                out.append(np.full(-k, 4, dtype=np.uint8))
                k = 0
            c = graph.contig[abs(cid) - 1]
            seg = c if cid > 0 else _rc(c)
            if k < len(seg):
                out.append(seg[k:])
    if not out:
        return np.zeros(0, dtype=np.uint8)
    return np.concatenate(out)


def node2seq(graph: ScaffoldGraph, node_id: int) -> np.ndarray:
    """writeNodeSeq equivalent: one node's gap-filled sequence;
    node_id is signed 1-based (negative = reverse complement)."""
    nd = graph.node[abs(node_id) - 1]
    return layout2seq(graph, [[node_id, 0, nd.length, 0]], 0, 1)


def layout_average_coverage(graph: ScaffoldGraph, layout: list, start: int,
                            n: int) -> float:
    """layoutAverageCoverage (scaffoldGraph.cpp:2282-2300)."""
    s, num = 0.0, 0
    for i in range(n):
        nd = graph.node[abs(layout[start + i][0]) - 1]
        for cid, _st, _ed in nd.contigs:
            ci = abs(cid) - 1
            num += len(graph.contig[ci])
            s += graph.coverage[ci] * len(graph.contig[ci])
    return s / num if num else 0.0


def align_scaffold(s1: np.ndarray, s2: np.ndarray, threshold: int) -> int:
    """alignScaffold (scaffoldGraph.cpp:2216-2277): banded edit distance
    with band half-width `threshold`; returns the final distance, or the
    band minimum (> threshold) on early exit. Columnar numpy over the
    band per row."""
    t = int(threshold)
    n1, n2 = len(s1), len(s2)
    if t <= 0:
        return 0 if n1 == n2 and np.array_equal(s1, s2) else 1
    big = t + n1 + n2 + 1
    if abs(n1 - n2) > t:
        return big
    w = 2 * t + 1
    idx = np.arange(w)
    # row i cell j holds D[i][i - t + j]; row 0: D[0][j2] = j2
    prev = np.where(idx >= t, idx - t, big).astype(np.int64)
    prev[np.minimum(idx - t, 0) + t > t + n2] = big  # (no-op guard)
    for m in range(n1):
        # cur[j] = D[m+1][(m+1) - t + j]; diag char s2[(m+1)-t+j-1]
        j2d = m - t + idx
        dvalid = (j2d >= 0) & (j2d < n2)
        eq = np.zeros(w, dtype=bool)
        eq[dvalid] = s2[j2d[dvalid]] == s1[m]
        diag = np.where(dvalid, prev + (~eq), big)
        up = np.concatenate([prev[1:], [big]]) + 1
        cur = np.minimum(diag, up)
        # left neighbor (insertion chain): cur[j] <= cur[i] + (j - i)
        # = (cur[i] - i) + j for any i <= j (self-inclusion is a no-op)
        cur = np.minimum(cur, np.minimum.accumulate(cur - idx) + idx)
        j2c = (m + 1) - t + idx
        cur[(j2c < 0) | (j2c > n2)] = big
        valid_min = cur.min()
        if valid_min > t:
            return int(min(valid_min, big))
        prev = cur
    return int(prev[n2 - n1 + t])


# ---------------------------------------------------------------------------
# bubble crushing / hetero removal on the scaffold graph
# ---------------------------------------------------------------------------

def _bubble_edge_pairs(graph: ScaffoldGraph):
    """Shared edge-pair enumeration and geometry filter of crushBubble /
    crushHeteroBubble / removeHeteroOverlap (scaffoldGraph.cpp:1652-1678)."""
    for ni, nd in enumerate(graph.node):
        for i in range(len(nd.edges) - 1):
            for j in range(i + 1, len(nd.edges)):
                e1, e2 = nd.edges[i], nd.edges[j]
                if e1.direction * e2.direction < 0:
                    continue
                n1 = graph.node[abs(e1.end) - 1]
                if (n1.state & SC_DEL) or e1.length + n1.length <= e2.length:
                    continue
                n2 = graph.node[abs(e2.end) - 1]
                if (n2.state & SC_DEL) or e2.length + n2.length <= e1.length:
                    continue
                if e1.direction > 0:
                    ee1, ee2 = e1.end, e2.end
                else:
                    ee1, ee2 = e2.end, e1.end
                if (abs(e1.length + n1.length - e2.length) <= graph.tolerence
                        + graph.scaffold_overlap(ee1, ee2)
                        or abs(e2.length + n2.length - e1.length)
                        <= graph.tolerence
                        + graph.scaffold_overlap(ee2, ee1)):
                    continue
                yield ni, e1, e2, n1, n2


def _delete_node(graph: ScaffoldGraph, nid1: int, ids: list) -> None:
    """Mark a node deleted: queue its edges for deletion and evict its
    contigs from contigPositionInScaffold."""
    nd = graph.node[nid1 - 1]
    for e in nd.edges:
        ids.append((nid1, e.end))
    for cid, _s, _e in nd.contigs:
        graph.contig_pos_id[abs(cid) - 1] = 0
    nd.state |= SC_DEL


def _common_prefix_suffix(layout1, layout2):
    """Shared left/right runs of two layouts (crushBubble
    scaffoldGraph.cpp:1937-1953). Returns (left_edge, right_edge) or None."""
    right = min(len(layout1), len(layout2))
    k = 0
    while k < right and layout1[k][0] == layout2[k][0]:
        k += 1
    if k == 0 or k == right:
        return None
    left_edge = k - 1
    k = 1
    while k <= right and layout1[-k][0] == layout2[-k][0]:
        k += 1
    if k == 1:
        return None
    right_edge = k - 1
    if abs(layout1[left_edge][0]) == abs(layout1[-right_edge][0]):
        return None
    return left_edge, right_edge


def crush_bubble(graph: ScaffoldGraph, bubble_threshold: float,
                 average_coverage: float) -> int:
    """crushBubble (scaffoldGraph.cpp:1888-2013): for edge pairs whose
    layouts re-converge, align the two inner sequences (banded) and absorb
    the lower-coverage branch; crushed sequences are recorded in
    graph.crushed_bubbles for printScaffoldBubble."""
    classify_node(graph)   # is_homo resets on every remake (scaffoldGraph.cpp:1632)
    num_crush = 0
    ids: list = []
    graph.detect_repeat(average_coverage)
    for ni, e1, e2, n1, n2 in _bubble_edge_pairs(graph):
        if n1.is_homo and n2.is_homo:
            continue
        layout1 = layout_nodes(graph, abs(e1.end) - 1)
        layout2 = layout_nodes(graph, abs(e2.end) - 1)
        edges = _common_prefix_suffix(layout1, layout2)
        if edges is None:
            continue
        left_edge, right_edge = edges
        cov1 = layout_average_coverage(
            graph, layout1, left_edge + 1,
            len(layout1) - right_edge - left_edge - 1)
        cov2 = layout_average_coverage(
            graph, layout2, left_edge + 1,
            len(layout2) - right_edge - left_edge - 1)
        layout_ref = layout1 if cov1 < cov2 else layout2
        if (right_edge + left_edge + 1 >= len(layout_ref)
                or cov1 + cov2 > average_coverage * 2.0):
            continue
        seq1 = layout2seq(graph, layout1, left_edge + 1,
                          len(layout1) - right_edge - left_edge - 1)
        seq2 = layout2seq(graph, layout2, left_edge + 1,
                          len(layout2) - right_edge - left_edge - 1)
        thr = int(max(len(seq1), len(seq2)) * bubble_threshold)
        if abs(len(seq1) - len(seq2)) > thr:
            continue
        if align_scaffold(seq1, seq2, thr) > thr:
            continue
        for lay in layout_ref[left_edge + 1: len(layout_ref) - right_edge]:
            _delete_node(graph, abs(lay[0]), ids)
        crushed = layout2seq(graph, layout_ref, left_edge + 1,
                             len(layout_ref) - right_edge - left_edge)
        graph.crushed_bubbles.append((crushed, min(cov1, cov2)))
        num_crush += 1
    graph.delete_edges(ids)
    for nd in graph.node:
        nd.state &= ~SC_REP
    LOG.counter("NUM_REMOVED_BUBBLES(ALIGNED)", num_crush)
    return num_crush


def crush_bubble_iterative(graph: ScaffoldGraph, bubble_threshold: float,
                           average_coverage: float) -> int:
    """crushBubbleIterative (scaffoldGraph.cpp:1095-1110)."""
    total = 0
    while True:
        n = crush_bubble(graph, bubble_threshold, average_coverage)
        total += n
        if n == 0:
            return total


def crush_hetero_bubble(graph: ScaffoldGraph,
                        average_coverage: float) -> int:
    """crushHeteroBubble. ScaffoldGraph variant (scaffoldGraph.cpp:
    1638-1745) when graph.hetero_coverage == 0: thresholds from
    average_coverage x MAX_HOMO/HETERO_RATE; PairedDBG variant
    (pairedDBG.cpp:1889-1994) otherwise: thresholds from heteroCoverage,
    single-node bubbles only, and the surviving pair is recorded in
    graph.bubble_pairs (bubbleFP/bubbleOpositeFP)."""
    paired_dbg = graph.hetero_coverage > 0
    if paired_dbg:
        homo_thr = 2.0 * HETERO_COVERAGE_THRESHOLD_FACTOR \
            * graph.hetero_coverage
        het_thr = HETERO_COVERAGE_THRESHOLD_FACTOR * graph.hetero_coverage
    else:
        homo_thr = average_coverage * MAX_HOMO_RATE + 0.5
        het_thr = average_coverage * MAX_HETERO_RATE + 0.5
    if graph.bubble_threshold == 0.0:
        return 0
    classify_node(graph)   # is_homo resets on every remake (scaffoldGraph.cpp:1632)
    num_crush = 0
    ids: list = []
    graph.detect_repeat(average_coverage)
    for ni, e1, e2, n1, n2 in _bubble_edge_pairs(graph):
        if n1.is_homo and n2.is_homo:
            continue
        layout1 = layout_nodes(graph, abs(e1.end) - 1)
        layout2 = layout_nodes(graph, abs(e2.end) - 1)
        edges = _common_prefix_suffix(layout1, layout2)
        if edges is None:
            continue
        left_edge, right_edge = edges
        if not paired_dbg and graph.node_coverage(
                graph.node[abs(layout1[left_edge][0]) - 1]) >= homo_thr:
            continue
        if graph.node_coverage(
                graph.node[abs(layout1[-right_edge][0]) - 1]) > homo_thr:
            continue
        cov1 = layout_average_coverage(
            graph, layout1, left_edge + 1,
            len(layout1) - right_edge - left_edge - 1)
        cov2 = layout_average_coverage(
            graph, layout2, left_edge + 1,
            len(layout2) - right_edge - left_edge - 1)
        layout_ref = layout1 if cov1 < cov2 else layout2
        if (right_edge + left_edge + 1 >= len(layout_ref)
                or cov1 > het_thr or cov2 > het_thr):
            continue
        n_in_bubble = len(layout_ref) - right_edge - left_edge - 1
        if paired_dbg:
            # PairedDBG: only single-node bubbles; keep the pair
            if n_in_bubble != 1:
                continue
            lay_id = left_edge + 1
            _delete_node(graph, abs(layout_ref[lay_id][0]), ids)
            if cov1 >= cov2:
                layout1, layout2 = layout2, layout1
            prim_nd = graph.node[abs(layout2[lay_id][0]) - 1]
            graph.bubble_pairs.append(
                (node2seq(graph, layout1[lay_id][0]),
                 abs(prim_nd.contigs[0][0])))
        else:
            for lay in layout_ref[left_edge + 1:
                                  len(layout_ref) - right_edge]:
                _delete_node(graph, abs(lay[0]), ids)
            crushed = layout2seq(graph, layout_ref, left_edge + 1,
                                 len(layout_ref) - right_edge - left_edge)
            graph.crushed_bubbles.append((crushed, min(cov1, cov2)))
        num_crush += 1
    graph.delete_edges(ids)
    for nd in graph.node:
        nd.state &= ~SC_REP
    LOG.counter("NUM_REMOVED_BUBBLES(COVERAGE_THRESHOLD)", num_crush)
    return num_crush


def delete_hetero_edge(graph: ScaffoldGraph) -> int:
    """deleteHeteroEdge. ScaffoldGraph variant (scaffoldGraph.cpp:
    2305-2352) with averageCoverage thresholds, PairedDBG thresholds
    (pairedDBG.cpp:1995-2047) when hetero_coverage is set: delete the
    shorter low-coverage branch of a conflicting edge pair."""
    paired_dbg = graph.hetero_coverage > 0
    if paired_dbg:
        homo_thr = 2.0 * HETERO_COVERAGE_THRESHOLD_FACTOR \
            * graph.hetero_coverage
        het_thr = HETERO_COVERAGE_THRESHOLD_FACTOR * graph.hetero_coverage
    else:
        homo_thr = int(graph.average_coverage * MAX_HOMO_RATE + 0.5)
        het_thr = int(graph.average_coverage * MAX_HETERO_RATE + 0.5)
    if graph.bubble_threshold == 0.0:
        return 0
    classify_node(graph)   # is_homo resets on every remake (scaffoldGraph.cpp:1632)
    num_delete = 0
    ids: list = []
    for ni, nd in enumerate(graph.node):
        for i in range(len(nd.edges)):
            for j in range(i + 1, len(nd.edges)):
                e1, e2 = nd.edges[i], nd.edges[j]
                n1 = graph.node[abs(e1.end) - 1]
                n2 = graph.node[abs(e2.end) - 1]
                if not graph._check_delete_edge(e1, e2, n1, n2):
                    continue
                if not paired_dbg and (n1.is_homo or n2.is_homo):
                    continue
                if graph.node_coverage(nd) > homo_thr:
                    continue
                cov1 = graph.node_coverage(n1)
                cov2 = graph.node_coverage(n2)
                victim_id = abs(e1.end)
                victim, vcov = n1, cov1
                if n1.length > n2.length:
                    victim, vcov, victim_id = n2, cov2, abs(e2.end)
                if paired_dbg:
                    if min(cov1, cov2) > het_thr:
                        continue
                else:
                    if max(cov1, cov2) > het_thr:
                        continue
                num_delete += 1
                _delete_node(graph, victim_id, ids)
    graph.delete_edges(ids)
    LOG.counter("NUM_DELETED_HETERO_EDGES", num_delete)
    return num_delete


def remove_hetero_overlap(graph: ScaffoldGraph) -> None:
    """removeHeteroOverlap (scaffoldGraph.cpp:2427-2510): delete the
    shorter of two overlapping branches when the longer contains it (edge
    between them with large negative gap) and its coverage is hetero-level;
    then rebuild the node table dropping SC_DEL nodes."""
    het_thr = int(graph.average_coverage * MAX_HETERO_RATE + 0.5)
    if graph.bubble_threshold == 0.0:
        return
    classify_node(graph)   # is_homo resets on every remake (scaffoldGraph.cpp:1632)
    num_delete = 0
    for ni, nd in enumerate(graph.node):
        for i in range(len(nd.edges) - 1):
            for j in range(i + 1, len(nd.edges)):
                e1, e2 = nd.edges[i], nd.edges[j]
                if (e1.direction * e2.direction < 0
                        or e1.length < -graph.tolerence
                        or e2.length < -graph.tolerence):
                    continue
                n1 = graph.node[abs(e1.end) - 1]
                if (n1.state & SC_DEL) or e1.length + n1.length <= e2.length:
                    continue
                n2 = graph.node[abs(e2.end) - 1]
                if (n2.state & SC_DEL) or e2.length + n2.length <= e1.length:
                    continue
                if n2.is_homo:
                    continue
                if e1.direction > 0:
                    ee1, ee2 = e1.end, e2.end
                else:
                    ee1, ee2 = e2.end, e1.end
                if (abs(e1.length + n1.length - e2.length) <= graph.tolerence
                        + graph.scaffold_overlap(ee1, ee2)
                        or abs(e2.length + n2.length - e1.length)
                        <= graph.tolerence
                        + graph.scaffold_overlap(ee2, ee1)):
                    continue
                if n1.length < n2.length:
                    n1, n2 = n2, n1
                    e1, e2 = e2, e1
                cov1 = graph.node_coverage(n1)
                cov2 = graph.node_coverage(n2)
                e3 = None
                for e in n1.edges:
                    if abs(e.end) == abs(e2.end):
                        e3 = e
                        break
                if e3 is None:
                    continue
                if ((n2.state & SC_DEL) or cov1 < cov2
                        or e3.length > -graph.tolerence
                        or e3.length < -n1.length or cov2 > het_thr):
                    continue
                for cid, _s, _e in n2.contigs:
                    graph.contig_pos_id[abs(cid) - 1] = 0
                n2.state |= SC_DEL
                num_delete += 1
    LOG.counter("NUM_REMOVED_OVERLAP_CONTIGS(CONTAINED_HETERO)", num_delete)
    # remake without SC_DEL nodes (scaffoldGraph.cpp:2492-2509)
    graph._remake([list(n.contigs) for n in graph.node
                   if not (n.state & SC_DEL)])


# ---------------------------------------------------------------------------
# PairedDBG DBG-bubble machinery
# ---------------------------------------------------------------------------

def _overlap_adjacency(graph: ScaffoldGraph):
    return graph._node_overlap_adjacency()


def get_overlapped_node(adj, sid: int) -> list[int]:
    """getOverlappedNode: overlap successors off the right end of signed
    node id `sid` (left end via -sid)."""
    return sorted(adj.get(sid, ()))


def _bubble_pair_scan(graph: ScaffoldGraph):
    """Core of getOverlappedBubbleNodeIndex / getOverlappedBubbleNodePairID
    (pairedDBG.cpp:866-980): source node with exactly two overlap
    successors that reconverge on a single sink."""
    adj = _overlap_adjacency(graph)
    for src in range(len(graph.node)):
        for direction in (-1, 1):
            sid = (src + 1) * direction
            branches = get_overlapped_node(adj, sid)
            if len(branches) != 2:
                continue
            sinks = []
            for b in branches:
                out = get_overlapped_node(adj, b)
                if len(out) != 1:
                    break
                sinks.append(out[0])
            if len(sinks) != 2 or sinks[0] != sinks[1]:
                continue
            # sink must also see exactly two predecessors
            back = get_overlapped_node(adj, -sinks[0])
            if len(back) != 2:
                continue
            yield branches[0], branches[1]


def get_overlapped_bubble_node_index(graph: ScaffoldGraph) -> list[int]:
    """getOverlappedBubbleNodeIndex (pairedDBG.cpp:866-913)."""
    flag = np.zeros(len(graph.node), dtype=bool)
    for b1, b2 in _bubble_pair_scan(graph):
        flag[abs(b1) - 1] = True
        flag[abs(b2) - 1] = True
    return list(np.nonzero(flag)[0])


def calculate_hetero_coverage(graph: ScaffoldGraph,
                              bubble_index: list[int],
                              contig_max_k: int) -> None:
    """calculateHeteroCoverage (pairedDBG.cpp:1092-1166): truncated
    length-weighted mean of bubble-node coverages (non-bubble nodes at
    half coverage pad the sample when bubbles are scarce)."""
    MIN_NUM_BUBBLE = 10000
    TRUNCATION_FACTOR = 2.0
    is_bubble = np.zeros(len(graph.node), dtype=bool)
    is_bubble[bubble_index] = True
    covs, lens = [], []
    for i, nd in enumerate(graph.node):
        if nd.length <= contig_max_k:
            continue
        if is_bubble[i]:
            covs.append(int(graph.node_coverage(nd) + 0.5))
            lens.append(nd.length)
        elif len(bubble_index) < MIN_NUM_BUBBLE:
            covs.append(int(graph.node_coverage(nd) / 2.0 + 0.5))
            lens.append(nd.length)
    if not covs:
        graph.hetero_coverage = 1.0
        graph.average_coverage = 2.0
        return
    c = np.array(covs, dtype=np.float64)
    w = np.array(lens, dtype=np.float64)
    mean = float(np.round((c * w).sum() / w.sum()))
    keep = (c >= mean / TRUNCATION_FACTOR) & (c <= mean * TRUNCATION_FACTOR)
    if keep.any():
        graph.hetero_coverage = float(
            np.round((c[keep] * w[keep]).sum() / w[keep].sum()))
    else:
        graph.hetero_coverage = mean
    graph.average_coverage = 2.0 * graph.hetero_coverage
    LOG.counter("ESTIMATED_HETERO_COVERAGE", graph.hetero_coverage)


def mark_bubble_hetero_node(graph: ScaffoldGraph, index: list[int],
                            max_factor: float = 2.0) -> None:
    """markBubbleHeteroNode (pairedDBG.cpp:1082-1090)."""
    max_cov = max_factor * graph.hetero_coverage
    for i in index:
        if graph.node_coverage(graph.node[i]) <= max_cov:
            graph.node[i].state |= DBG_HETERO


def extract_dbg_bubble_information(graph: ScaffoldGraph,
                                   contig_max_k: int) -> None:
    """extractDBGBubbleInformation (pairedDBG.cpp:1213-1225)."""
    index = get_overlapped_bubble_node_index(graph)
    if graph.hetero_coverage <= 0.0:
        calculate_hetero_coverage(graph, index, contig_max_k)
    mark_bubble_hetero_node(graph, index, 2.0)


def crush_simple_dbg_bubble(graph: ScaffoldGraph) -> int:
    """crushSimpleDBGBubble (pairedDBG.cpp:1226-1303): remove the
    lower-coverage branch of source->2 branches->sink overlap bubbles;
    record (secondary, primary) sequence pairs."""
    threshold = graph.hetero_coverage * 3.0
    num_crush = 0
    ids: list = []
    for b1, b2 in _bubble_pair_scan(graph):
        n1 = graph.node[abs(b1) - 1]
        n2 = graph.node[abs(b2) - 1]
        if (n1.state & SC_DEL) or (n2.state & SC_DEL):
            continue
        cov1 = graph.node_coverage(n1)
        cov2 = graph.node_coverage(n2)
        if cov1 + cov2 > threshold:
            continue
        if cov1 > cov2:
            n1, n2 = n2, n1
            b1, b2 = b2, b1
        _delete_node(graph, abs(b1), ids)
        graph.bubble_pairs.append((node2seq(graph, b1),
                                   abs(n2.contigs[0][0])))
        num_crush += 1
    graph.delete_edges(ids)
    LOG.counter("NUM_CRUSHED_DBG_BUBBLES", num_crush)
    return num_crush


def set_opposite_bubble_contig_id_overlapped(graph: ScaffoldGraph) -> None:
    """setOppositeBubbleContigIDOverlapped (pairedDBG.cpp:2613-2660):
    record each bubble contig's partner contig on the opposite branch."""
    thr = HETERO_COVERAGE_THRESHOLD_FACTOR * graph.hetero_coverage
    for b1, b2 in _bubble_pair_scan(graph):
        n1 = graph.node[abs(b1) - 1]
        n2 = graph.node[abs(b2) - 1]
        if graph.node_coverage(n1) > thr or graph.node_coverage(n2) > thr:
            continue
        _assign_opposite(graph, b1, b2)
        _assign_opposite(graph, b2, b1)


def _assign_opposite(graph, sid_a, sid_b):
    sgn_b = 1 if sid_b > 0 else -1
    nb = graph.node[abs(sid_b) - 1]
    rep = sgn_b * nb.contigs[0][0]
    for cid, _s, _e in nb.contigs:
        if graph.contig_pos_id[abs(cid) - 1] != 0:
            rep = sgn_b * cid
            break
    sgn_a = 1 if sid_a > 0 else -1
    na = graph.node[abs(sid_a) - 1]
    for cid, _s, _e in na.contigs:
        scid = sgn_a * cid
        ci = abs(scid) - 1
        if graph.contig_pos_id[ci] != 0 \
                and graph.opposite_bubble_contig_id[ci] == 0:
            graph.opposite_bubble_contig_id[ci] = \
                (1 if scid > 0 else -1) * rep


def set_opposite_bubble_node_ids(graph: ScaffoldGraph) -> None:
    """Derive node-level opposite ids from contig-level votes
    (setOppositeBubbleNodeID/fillMajorityIDRun essence, pairedDBG.cpp:
    2726-2760): each node's opposite is the majority opposite node over
    its contigs' recorded partners; mark the lower-coverage side
    DBG_SECONDARY_BUBBLE."""
    for ni, nd in enumerate(graph.node):
        votes: dict[int, int] = {}
        for cid, _s, _e in nd.contigs:
            ci = abs(cid) - 1
            opp = graph.opposite_bubble_contig_id[ci]
            if opp == 0:
                continue
            opp_signed = opp if cid > 0 else -opp
            onid = graph.contig_pos_id[abs(opp_signed) - 1]
            if onid == 0:
                continue
            signed = onid if opp_signed > 0 else -onid
            votes[signed] = votes.get(signed, 0) + 1
        if not votes:
            nd.opposite_bubble_node_id = 0
            continue
        best = max(votes.items(), key=lambda kv: kv[1])[0]
        if abs(best) == ni + 1:
            nd.opposite_bubble_node_id = 0
            continue
        nd.opposite_bubble_node_id = best
    # mutual pairs: mark secondary on the lower-coverage side
    for ni, nd in enumerate(graph.node):
        opp = nd.opposite_bubble_node_id
        if opp == 0:
            continue
        other = graph.node[abs(opp) - 1]
        if abs(other.opposite_bubble_node_id) != ni + 1:
            continue
        if graph.node_coverage(nd) < graph.node_coverage(other) or \
                (graph.node_coverage(nd) == graph.node_coverage(other)
                 and abs(opp) < ni + 1):
            nd.state |= DBG_SECONDARY_BUBBLE
