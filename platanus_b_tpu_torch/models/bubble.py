"""Bubble-tracked haplotype phasing machinery for the PairedDBG graph.

The reference's default `solve_DBG` flow (solveDBG.cpp:266-637) divides
and pairs scaffolds by tracking, per contig, its opposite-haplotype
bubble partner (oppositeBubbleContigID), lifting that to node level
(oppositeBubbleNodeID + PRIMARY/SECONDARY states), and repeatedly
dividing nodes where the opposite-node vote switches. This module is the
host-side re-design of that machinery over models.scaffold.ScaffoldGraph;
every function cites its pairedDBG.cpp origin. The graph is small (host
numpy/python is the idiomatic split — device work stays in mapping and
counting).

Port copy of platanus_b_tpu/models/bubble.py: the reference's text, its
relative imports resolving to the port's modules (scaffold, hetero, divide, log).
No other change.
"""

from __future__ import annotations

import numpy as np

from ..utils.log import LOG
from .divide import _max_length_contig_id, smooth_node_id_vector
from .hetero import _overlap_adjacency, get_overlapped_node, _bubble_pair_scan
from .scaffold import (DBG_CONTIG_BUBBLE_JUNCTION, DBG_CONTIG_PRIMARY_BUBBLE,
                       DBG_CONTIG_SECONDARY_BUBBLE, DBG_PRIMARY_BUBBLE,
                       DBG_SECONDARY_BUBBLE, HETERO_COVERAGE_THRESHOLD_FACTOR,
                       SC_DEL, ScaffoldGraph)


# ---------------------------------------------------------------------------
# contig-level bubble pairing
# ---------------------------------------------------------------------------

def set_opposite_bubble_contig_id_by_end_match(graph: ScaffoldGraph,
                                               first_bubble_contig: int = 0
                                               ) -> None:
    """setOppositeBubbleContigIDByEndMatch (pairedDBG.cpp:6105-6139):
    input bubble contigs (index >= first_bubble_contig) sharing identical
    (first maxK-1 + last maxK-1 bases) end sequences pair up as opposite
    haplotypes when the end key occurs exactly twice."""
    k1 = graph.contig_max_k - 1
    end_map: dict[bytes, list] = {}
    for i in range(first_bubble_contig, graph.num_contig):
        c = graph.contig[i]
        if len(c) < graph.contig_max_k:
            continue
        key = c[:k1].tobytes() + c[len(c) - k1:].tobytes()
        end_map.setdefault(key, []).append(i)
    n_pairs = 0
    for ids in end_map.values():
        if len(ids) == 2:
            graph.opposite_bubble_contig_id[ids[0]] = ids[1] + 1
            graph.opposite_bubble_contig_id[ids[1]] = ids[0] + 1
            n_pairs += 1
    LOG.counter("NUM_END_MATCHED_BUBBLE_PAIRS", n_pairs)


# ---------------------------------------------------------------------------
# node-level opposite ids + primary/secondary states
# ---------------------------------------------------------------------------

def _opposite_node_vector(graph: ScaffoldGraph, parts,
                          strand_aware: bool = False) -> list[int]:
    """setOppositeBubbleNodeID(/StrandAware) (pairedDBG.cpp:2884-2905):
    per layout part, the (abs or signed) node id holding the part's
    opposite bubble contig; 0 when absent or same-node."""
    out = []
    for cid, _s, _e in parts:
        ci = abs(cid) - 1
        opp = int(graph.opposite_bubble_contig_id[ci])
        if opp == 0:
            out.append(0)
            continue
        own = abs(int(graph.contig_pos_id[ci]))
        onid = int(graph.contig_pos_id[abs(opp) - 1])
        if onid == 0 or own == abs(onid):
            out.append(0)
        elif strand_aware:
            out.append(onid)
        else:
            out.append(abs(onid))
    return out


def _flip_opposite_node_vector(graph: ScaffoldGraph, ids: list[int],
                               parts) -> None:
    """flipOppositeBubbleNodeID (pairedDBG.cpp:2906-2919): re-sign each
    vote by the part's own strand."""
    for i, (cid, _s, _e) in enumerate(parts):
        ci = abs(cid) - 1
        opp = int(graph.opposite_bubble_contig_id[ci])
        onid = int(graph.contig_pos_id[abs(opp) - 1]) if opp else 0
        if onid == 0 or abs(onid) == abs(ids[i]):
            ids[i] = (1 if cid > 0 else -1) * onid


def _node_cov_threshold(graph: ScaffoldGraph, length: int) -> float:
    """Length-relaxed hetero-coverage gate (pairedDBG.cpp:3065-3067)."""
    return graph.hetero_coverage * max(
        1.25, HETERO_COVERAGE_THRESHOLD_FACTOR - 0.25 * 0.00001 * length)


def _node_lengths(graph: ScaffoldGraph) -> np.ndarray:
    return np.array([n.length for n in graph.node], dtype=np.int64)


def set_opposite_bubble_node_id_for_each_node(graph: ScaffoldGraph) -> None:
    """setOppositeBubbleNodeIDForEachNode (pairedDBG.cpp:3043-3076)."""
    nl = _node_lengths(graph)
    for nd in graph.node:
        nd.opposite_bubble_node_id = 0
        nd.state &= ~(DBG_PRIMARY_BUBBLE | DBG_SECONDARY_BUBBLE)
    if not graph.opposite_bubble_contig_id.any():
        return
    for ni, nd in enumerate(graph.node):
        ids = _opposite_node_vector(graph, nd.contigs)
        opp = _max_length_contig_id(ids, nl, 0, len(ids))
        if opp == 0:
            continue
        if (graph.node_coverage(nd) > _node_cov_threshold(graph, nd.length)
                or graph.node_coverage(graph.node[abs(opp) - 1])
                > _node_cov_threshold(graph, nl[abs(opp) - 1])):
            continue
        if abs(opp) - 1 == ni:
            continue
        nd.opposite_bubble_node_id = opp


def _num_edge_direction(nd) -> int:
    """getNumEdgeDirectionOfNode (pairedDBG.cpp:3195-3208)."""
    left = any(e.direction > 0 for e in nd.edges)
    right = any(e.direction < 0 for e in nd.edges)
    return int(left) + int(right)


def _non_gap_length(nd) -> int:
    """getNonGapContigLengthOfNode (pairedDBG.cpp:3183-3193)."""
    if not nd.contigs:
        return 0
    gap = sum(nd.contigs[i + 1][1] - nd.contigs[i][2]
              for i in range(len(nd.contigs) - 1))
    return nd.contigs[-1][2] - gap


def set_opposite_bubble_node_id_and_state_for_each_node(
        graph: ScaffoldGraph) -> None:
    """setOppositeBubbleNodeIDAndStateForEachNode (pairedDBG.cpp:
    3077-3181): pair nodes and mark the worse side SECONDARY (fewer edge
    directions, then shorter non-gap length, then lower coverage, then
    index), the better side PRIMARY; propagate to contig_state."""
    set_opposite_bubble_node_id_for_each_node(graph)
    graph.contig_state &= ~(DBG_CONTIG_PRIMARY_BUBBLE
                            | DBG_CONTIG_SECONDARY_BUBBLE)
    for ni, nd in enumerate(graph.node):
        opp = nd.opposite_bubble_node_id
        if opp == 0:
            continue
        oi = abs(opp) - 1
        other = graph.node[oi]
        d1, d2 = _num_edge_direction(nd), _num_edge_direction(other)
        if d1 != d2:
            loser = other if d1 > d2 else nd
        else:
            l1, l2 = _non_gap_length(nd), _non_gap_length(other)
            if l1 != l2:
                loser = other if l1 > l2 else nd
            else:
                c1 = graph.node_coverage(nd)
                c2 = graph.node_coverage(other)
                if c1 != c2:
                    loser = other if c1 > c2 else nd
                else:
                    loser = other if ni < oi else nd
        loser.state |= DBG_SECONDARY_BUBBLE
        winner = nd if loser is other else other
        winner.state |= DBG_PRIMARY_BUBBLE
    for ci in range(graph.num_contig):
        pid = int(graph.contig_pos_id[ci])
        if pid == 0:
            continue
        st = graph.node[abs(pid) - 1].state
        if st & DBG_PRIMARY_BUBBLE:
            graph.contig_state[ci] |= DBG_CONTIG_PRIMARY_BUBBLE
        elif st & DBG_SECONDARY_BUBBLE:
            graph.contig_state[ci] |= DBG_CONTIG_SECONDARY_BUBBLE


def adjust_opposite_bubble_node_id_direction(graph: ScaffoldGraph) -> None:
    """adjustOppositeBubbleNodeIDDirection (pairedDBG.cpp:4712-4730)."""
    for nd in graph.node:
        if not (nd.state & (DBG_PRIMARY_BUBBLE | DBG_SECONDARY_BUBBLE)):
            continue
        for cid, _s, _e in (nd.contigs[:1] + nd.contigs[-1:]):
            opp = int(graph.opposite_bubble_contig_id[abs(cid) - 1])
            if opp != 0:
                onid = int(graph.contig_pos_id[abs(opp) - 1])
                sgn = ((1 if cid > 0 else -1) * (1 if opp > 0 else -1)
                       * (1 if onid > 0 else -1 if onid < 0 else 0))
                nd.opposite_bubble_node_id = sgn * abs(
                    nd.opposite_bubble_node_id)
                break


# ---------------------------------------------------------------------------
# bubble-junction contig marking
# ---------------------------------------------------------------------------

def set_bubble_junction_contig_id_overlapped(graph: ScaffoldGraph) -> None:
    """setBubbleJunctionContigIDOverlapped (pairedDBG.cpp:3412-3489):
    contigs at node-ends whose both overlap successors are (hetero-
    coverage) bubble nodes are junction contigs; record the joined
    neighbor contig ids."""
    thr = HETERO_COVERAGE_THRESHOLD_FACTOR * graph.hetero_coverage
    graph.contig_state &= ~DBG_CONTIG_BUBBLE_JUNCTION
    bubble_flag = np.zeros(len(graph.node), dtype=bool)
    for b1, b2 in _bubble_pair_scan(graph):
        if (graph.node_coverage(graph.node[abs(b1) - 1]) <= thr
                and graph.node_coverage(graph.node[abs(b2) - 1]) <= thr):
            bubble_flag[abs(b1) - 1] = True
            bubble_flag[abs(b2) - 1] = True
    adj = _overlap_adjacency(graph)
    for ni, nd in enumerate(graph.node):
        if not nd.contigs:
            continue
        for direction in (-1, 1):
            sid = (ni + 1) * direction
            nbrs = get_overlapped_node(adj, sid)
            if len(nbrs) != 2:
                continue
            if not all(bubble_flag[abs(x) - 1] for x in nbrs):
                continue
            first = nbrs[0]
            fn = graph.node[abs(first) - 1]
            joined = (fn.contigs[0][0] if first > 0
                      else -fn.contigs[-1][0])
            if direction > 0:
                cid = nd.contigs[-1][0]
                side = 1 if cid > 0 else 0
            else:
                cid = nd.contigs[0][0]
                joined = (fn.contigs[-1][0] if first > 0
                          else -fn.contigs[0][0])
                side = 0 if cid > 0 else 1
            ci = abs(cid) - 1
            graph.contig_state[ci] |= DBG_CONTIG_BUBBLE_JUNCTION
            graph.joined_bubble_contig_id[ci, side] = joined


def mark_junction_contig_joined_to_bubble(graph: ScaffoldGraph) -> None:
    """markJunctionContigJoinedToBubble (pairedDBG.cpp:3490-3514)."""
    graph.contig_state &= ~DBG_CONTIG_BUBBLE_JUNCTION
    bubble_edge = np.zeros(graph.num_contig, dtype=bool)
    for nd in graph.node:
        if nd.state & (DBG_PRIMARY_BUBBLE | DBG_SECONDARY_BUBBLE) \
                and nd.contigs:
            bubble_edge[abs(nd.contigs[0][0]) - 1] = True
            bubble_edge[abs(nd.contigs[-1][0]) - 1] = True
    for nd in graph.node:
        for cid, _s, _e in nd.contigs:
            ci = abs(cid) - 1
            for side in range(2):
                j = int(graph.joined_bubble_contig_id[ci, side])
                if j != 0 and bubble_edge[abs(j) - 1]:
                    graph.contig_state[ci] |= DBG_CONTIG_BUBBLE_JUNCTION


# ---------------------------------------------------------------------------
# bubble-driven node division
# ---------------------------------------------------------------------------

def divide_node_using_bubble_contig_pair(graph: ScaffoldGraph,
                                         strand_aware: bool = False) -> int:
    """divideNodeUsingBubbleContigPair(/StrandAware) (pairedDBG.cpp:
    2709-2883): smooth each node's opposite-node vote vector (majority-run
    filling, score factor 1.0) and split where the vote switches."""
    nl = _node_lengths(graph)
    bp = graph._blank_breakpoints()
    total = 0
    for ni, nd in enumerate(graph.node):
        parts = nd.contigs
        ids = _opposite_node_vector(graph, parts)
        if strand_aware:
            # fill once, re-sign by part strand, then smooth the signed
            # votes (pairedDBG.cpp:2811-2829)
            from .divide import _fill_majority_id_run
            _fill_majority_id_run(ids, nl, (0, len(ids)), 1.0)
            _flip_opposite_node_vector(graph, ids, parts)
            smooth_node_id_vector(ids, nl, 1.0)
            for i in range(len(ids)):
                if ids and ids[i] == ids[-1]:
                    if not bp[ni][i]:
                        bp[ni][i] = True
                        if i != 0:
                            total += 1
                    break
        else:
            smooth_node_id_vector(ids, nl, 1.0)
            for i in range(1, len(ids)):
                if ids[i - 1] != ids[i]:
                    if not bp[ni][i]:
                        bp[ni][i] = True
                        total += 1
    if total:
        graph.split_nodes_at_breakpoints(bp)
    return total


def divide_inconsistent_bubble_end(graph: ScaffoldGraph) -> int:
    """divideInconsistentBubbleEnd (pairedDBG.cpp:4585-4711): iterate to a
    fixed point where every bubble node is broken wherever its opposite
    contig's node has a break at the matching end."""
    set_opposite_bubble_node_id_and_state_for_each_node(graph)
    bp = graph._blank_breakpoints()
    left_end = np.zeros(graph.num_contig, dtype=bool)
    right_end = np.zeros(graph.num_contig, dtype=bool)
    total = -1
    num = 1
    while num > 0:
        total += num
        num = 0
        for ni, nd in enumerate(graph.node):
            if not (nd.state & (DBG_PRIMARY_BUBBLE | DBG_SECONDARY_BUBBLE)):
                continue
            for i, (cid, _s, _e) in enumerate(nd.contigs):
                ci = abs(cid) - 1
                if bp[ni][i]:
                    (left_end if cid > 0 else right_end)[ci] = True
                if bp[ni][i + 1]:
                    (right_end if cid > 0 else left_end)[ci] = True
        for ni, nd in enumerate(graph.node):
            if not (nd.state & (DBG_PRIMARY_BUBBLE | DBG_SECONDARY_BUBBLE)):
                continue
            for i, (cid, _s, _e) in enumerate(nd.contigs):
                ci = abs(cid) - 1
                opp = (1 if cid > 0 else -1) \
                    * int(graph.opposite_bubble_contig_id[ci])
                if opp == 0:
                    continue
                opos = abs(int(graph.contig_pos_id[abs(opp) - 1]))
                if opos != ni + 1 and \
                        opos != abs(nd.opposite_bubble_node_id):
                    continue
                oi = abs(opp) - 1
                if opp > 0:
                    if left_end[oi] and not bp[ni][i]:
                        bp[ni][i] = True
                        num += 1
                    if right_end[oi] and not bp[ni][i + 1]:
                        bp[ni][i + 1] = True
                        num += 1
                else:
                    if left_end[oi] and not bp[ni][i + 1]:
                        bp[ni][i + 1] = True
                        num += 1
                    if right_end[oi] and not bp[ni][i]:
                        bp[ni][i] = True
                        num += 1
    if total > 0:
        graph.split_nodes_at_breakpoints(bp)
    return max(total, 0)


def divide_node_based_on_bubbles_iterative(graph: ScaffoldGraph,
                                           strand_flag: bool) -> int:
    """divideNodeBasedOnBubblesIterative (pairedDBG.cpp:4767-4790)."""
    LOG.info("dividing nodes based on bubbles ...")
    total = 0
    for _ in range(20):   # safety cap; the reference loops to fixed point
        num = divide_node_using_bubble_contig_pair(graph)
        num += divide_inconsistent_bubble_end(graph)
        if strand_flag:
            num += divide_node_using_bubble_contig_pair(graph,
                                                        strand_aware=True)
        total += num
        LOG.counter("NUM_DIVISION", num)
        if num == 0:
            break
    LOG.counter("TOTAL_NUM_DIVISIONS", total)
    return total


def divide_bubble_contig_in_non_hetero_node(graph: ScaffoldGraph) -> int:
    """divideBubbleContigInNonHeteroNode (pairedDBG.cpp:3608-3677): in
    nodes without an opposite partner, excise contigs that carry a bubble
    pairing into their own nodes."""
    set_opposite_bubble_node_id_and_state_for_each_node(graph)
    bp = graph._blank_breakpoints()
    num = 0
    for ni, nd in enumerate(graph.node):
        if nd.opposite_bubble_node_id != 0 or len(nd.contigs) <= 1:
            continue
        for i, (cid, _s, _e) in enumerate(nd.contigs):
            if graph.opposite_bubble_contig_id[abs(cid) - 1] != 0:
                bp[ni][i] = True
                bp[ni][i + 1] = True
                num += 1
    if num:
        graph.split_nodes_at_breakpoints(bp)
    return num


def divide_bubble_junction_node(graph: ScaffoldGraph,
                                gap_divide: bool) -> int:
    """divideBubbleJunctionNode (pairedDBG.cpp:3515-3607): split scaffolds
    next to bubble-junction contigs (and, in gap mode, at any weak joint
    of non-paired nodes)."""
    LOG.info("dividing scaffolds at bubble-junctions...")
    set_opposite_bubble_node_id_and_state_for_each_node(graph)
    mark_junction_contig_joined_to_bubble(graph)
    min_overlap_to_join = 20
    max_k = graph.contig_max_k
    bp = graph._blank_breakpoints()
    num = 0
    for ni, nd in enumerate(graph.node):
        c = nd.contigs
        if gap_divide:
            if nd.opposite_bubble_node_id != 0:
                continue
            for i in range(1, len(c)):
                junction = (graph.contig_state[abs(c[i - 1][0]) - 1]
                            | graph.contig_state[abs(c[i][0]) - 1]) \
                    & DBG_CONTIG_BUBBLE_JUNCTION
                ov = graph.get_overlap(c[i - 1][0], c[i][0])
                if (junction and ov < max_k) or c[i][1] > c[i - 1][2] \
                        or ov < min_overlap_to_join:
                    bp[ni][i] = True
                    num += 1
        else:
            for i in range(1, len(c)):
                junction = (graph.contig_state[abs(c[i - 1][0]) - 1]
                            | graph.contig_state[abs(c[i][0]) - 1]) \
                    & DBG_CONTIG_BUBBLE_JUNCTION
                if junction and graph.get_overlap(c[i - 1][0],
                                                  c[i][0]) < max_k - 1:
                    bp[ni][i] = True
                    num += 1
    if num:
        graph.split_nodes_at_breakpoints(bp)
    return num


# ---------------------------------------------------------------------------
# bubble-aware edge cleaning + secondary removal / recovery
# ---------------------------------------------------------------------------

def delete_different_bubble_edge(graph: ScaffoldGraph) -> int:
    """deleteDifferentBubbleEdge (pairedDBG.cpp:3209-3248): among
    conflicting edges, drop the one whose target disagrees with the
    source's opposite-bubble assignment while the other agrees."""
    ids = []
    for ni, nd in enumerate(graph.node):
        if nd.opposite_bubble_node_id == 0:
            continue
        for a in range(len(nd.edges) - 1):
            for b in range(a + 1, len(nd.edges)):
                e1, e2 = nd.edges[a], nd.edges[b]
                n1 = graph.node[abs(e1.end) - 1]
                n2 = graph.node[abs(e2.end) - 1]
                if not graph._check_delete_edge(e1, e2, n1, n2):
                    continue
                s1 = (1 if e1.end > 0 else -1) * n1.opposite_bubble_node_id
                s2 = (1 if e2.end > 0 else -1) * n2.opposite_bubble_node_id
                own = nd.opposite_bubble_node_id
                if own != s1 and own == s2:
                    ids.append((ni + 1, e1.end))
                elif own != s2 and own == s1:
                    ids.append((ni + 1, e2.end))
    graph.delete_edges(ids)
    return len(ids)


def delete_different_bubble_edge_iterative(graph: ScaffoldGraph) -> int:
    """deleteDifferentBubbleEdgeIterative (pairedDBG.cpp:3250-3266)."""
    LOG.info("removing edges between nodes with different bubble "
             "assignments...")
    set_opposite_bubble_node_id_for_each_node(graph)
    total = 0
    while True:
        n = delete_different_bubble_edge(graph)
        LOG.counter("NUM_REMOVED_EDGES", n)
        total += n
        if n == 0:
            break
    return total


def delete_conflicting_bubble_edge(graph: ScaffoldGraph) -> int:
    """deleteConflictingBubbleEdge (pairedDBG.cpp:3288-3340): for nodes
    with an opposite partner, of two conflicting edges keep the
    dominant-link one (0.25 rate)."""
    CROSS_LINK_RATE_THRESHOLD = 0.25
    set_opposite_bubble_node_id_for_each_node(graph)
    ids = []
    n_del = 0
    for ni, nd in enumerate(graph.node):
        if nd.opposite_bubble_node_id == 0:
            continue
        for a in range(len(nd.edges) - 1):
            for b in range(a + 1, len(nd.edges)):
                e1, e2 = nd.edges[a], nd.edges[b]
                n1 = graph.node[abs(e1.end) - 1]
                n2 = graph.node[abs(e2.end) - 1]
                if not graph._check_delete_edge(e1, e2, n1, n2):
                    continue
                if n1.opposite_bubble_node_id != 0 and \
                        n1.opposite_bubble_node_id != \
                        (1 if e1.end > 0 else -1) * e2.end:
                    continue
                if e1.num_link < CROSS_LINK_RATE_THRESHOLD * e2.num_link:
                    ids.append((ni + 1, e1.end))
                    n_del += 1
                elif e2.num_link < CROSS_LINK_RATE_THRESHOLD * e1.num_link:
                    ids.append((ni + 1, e2.end))
                    n_del += 1
    graph.delete_edges(ids)
    return n_del


def delete_secondary_bubble_node_and_edge(graph: ScaffoldGraph) -> int:
    """deleteSecondaryBubbleNodeAndEdge (pairedDBG.cpp:3341-3369)."""
    set_opposite_bubble_node_id_and_state_for_each_node(graph)
    LOG.info("removing secondary bubbles from scaffold graph...")
    ids = []
    n_del = 0
    for ni, nd in enumerate(graph.node):
        if not (nd.state & DBG_SECONDARY_BUBBLE):
            continue
        n_del += 1
        nd.state |= SC_DEL
        for e in nd.edges:
            ids.append((ni + 1, e.end))
    LOG.counter("TOTAL_NUM_DELETED_NODES", n_del)
    graph.delete_edges(ids)
    return n_del


def copy_all_nodes(graph: ScaffoldGraph) -> list:
    """copyAllNodes: snapshot of (contigs, state, opposite id) per node
    for later secondary-bubble recovery."""
    return [(list(nd.contigs), nd.state, nd.opposite_bubble_node_id)
            for nd in graph.node]


def remake_graph_recovering_secondary_bubble(graph: ScaffoldGraph,
                                             snapshot: list) -> None:
    """remakeGraphRecoveringSecondaryBubble (pairedDBG.cpp:4891-4921):
    current live nodes + the snapshot's secondary-bubble nodes."""
    new_nodes = [list(nd.contigs) for nd in graph.node
                 if not (nd.state & SC_DEL) and nd.contigs]
    for contigs, state, _opp in snapshot:
        if (state & SC_DEL) or not (state & DBG_SECONDARY_BUBBLE):
            continue
        new_nodes.append(list(contigs))
    graph._remake(new_nodes)


# ---------------------------------------------------------------------------
# phased outputs
# ---------------------------------------------------------------------------

def classify_result_nodes(graph: ScaffoldGraph, results):
    """outputResultSeqWithBubble's classification (pairedDBG.cpp:
    2296-2389): mutually paired nodes become (primary record, oriented
    secondary seq, secondary coverage) triples; unpaired nodes split into
    non_bubble_hetero (secondary-state) vs non_bubble_other records.
    Returns (paired, hetero_records, other_records, leftover_results)
    where leftover_results are the unpaired non-redundant records (for an
    optional post-hoc pairing fallback)."""
    by_node = {r.node_index: r for r in results}
    n_nodes = len(graph.node)
    pair_flag = np.zeros(n_nodes, dtype=bool)
    for ni, nd in enumerate(graph.node):
        r = by_node.get(ni)
        if r is None or len(r.seq) == 0 or (nd.state & SC_DEL):
            continue
        opp = nd.opposite_bubble_node_id
        if opp != 0:
            other = graph.node[abs(opp) - 1]
            if other.opposite_bubble_node_id != 0 and \
                    abs(other.opposite_bubble_node_id) - 1 == ni:
                pair_flag[ni] = True

    paired, hetero, other = [], [], []
    for ni, nd in enumerate(graph.node):
        if not pair_flag[ni] or (nd.state & DBG_SECONDARY_BUBBLE):
            continue
        alt_i = abs(nd.opposite_bubble_node_id) - 1
        r, ra = by_node.get(ni), by_node.get(alt_i)
        if r is None or ra is None:
            continue
        if r.redundant and ra.redundant:
            continue
        alt_seq = ra.seq
        if nd.opposite_bubble_node_id < 0:
            alt_seq = np.where(alt_seq < 4, 3 - alt_seq, alt_seq)[::-1]
        paired.append((r, int(graph.node_coverage(nd) + 0.5), alt_seq,
                       int(graph.node_coverage(graph.node[alt_i]) + 0.5)))
    leftovers = []
    for ni, nd in enumerate(graph.node):
        r = by_node.get(ni)
        if r is None or len(r.seq) == 0 or (nd.state & SC_DEL) \
                or pair_flag[ni] or r.redundant:
            continue
        if nd.state & DBG_SECONDARY_BUBBLE:
            hetero.append((r, int(graph.node_coverage(nd) + 0.5)))
        else:
            leftovers.append((r, int(graph.node_coverage(nd) + 0.5)))
    return paired, hetero, other, leftovers
