"""Base-level erroneous-node division (PairedDBG division machinery).

Re-design of divideErroneousNodeBaseLevel and its coverage tracks
(pairedDBG.cpp:6480-7294) plus the junction-level divideErroneousNode
(pairedDBG.cpp:5660-5724, counts :5020-5659):

- physical coverage       <- calculatePhysicalCoverage (pairedDBG.cpp:6552-6663)
- gap-rate compensation   <- compensatePhysicalCoverageBasedOnGapRate (:6761-6793)
- diff (conflict) coverage<- calculateDiffCoverage (:6796-6940)
- long-read tracks        <- calculateLongReadPhysicalCoverage (:6665-6759),
                             calculateLongReadDiffCoverage (:6943-7057)
- breakpoint detection    <- detectBreakpointBasedOnCoverage (:7078-7100)
- contig-boundary split   <- detectContigBoundaryBreakpoints (:7120-7138) +
                             divideNodeBasedOnCoverage (:7165-7294)
- junction-level division <- countPairsSpanningGap (:5020-5100),
                             countLinksInsideContigs (:5171-5400),
                             divideErroneousLink (:4923-5018)

All per-pair work is columnar numpy over the lifted MappedPairs arrays;
the reference's per-record locked loops become difference-array
accumulations over one concatenated per-node base axis.

Port copy of platanus_b_tpu/models/divide.py: the reference's text, its
relative imports resolving to the port's modules (scaffold, hetero, log).
No other change.
"""

from __future__ import annotations

import numpy as np

from ..utils.log import LOG
from .scaffold import ScaffoldGraph

# divideNodeBasedOnCoverage constants (pairedDBG.cpp:7167-7172)
MIN_COVERAGE_RATE = 0.5
MAX_DIFF_COVERAGE_RATE = 2.0
MIN_MEDIAN_COVERAGE = 2
MIN_DIFF_COVERAGE = 3


def _layout(graph: ScaffoldGraph):
    node_len = np.array([n.length for n in graph.node], dtype=np.int64)
    starts = np.zeros(len(node_len) + 1, dtype=np.int64)
    np.cumsum(node_len, out=starts[1:])
    return node_len, starts[:-1], int(starts[-1])


def _accumulate_ranges(total: int, g_lo: np.ndarray, g_hi: np.ndarray,
                       out: np.ndarray) -> None:
    """out[g_lo..g_hi] += 1 per row (inclusive), via a difference array."""
    ok = g_hi >= g_lo
    d = np.zeros(total + 1, dtype=np.int64)
    np.add.at(d, g_lo[ok], 1)
    np.add.at(d, g_hi[ok] + 1, -1)
    out += np.cumsum(d[:total])


def _lift_pairs(graph: ScaffoldGraph, mp, lift):
    f_sid, f_off, f_part = graph.lift_positions(mp.fwd_id, mp.fwd_off, lift)
    r_sid, r_off, r_part = graph.lift_positions(mp.rev_id, mp.rev_off, lift)
    both = (mp.fwd_id != 0) & (mp.rev_id != 0) & (f_sid != 0) & (r_sid != 0)
    return f_sid, f_off, f_part, r_sid, r_off, r_part, both


def physical_coverage(graph: ScaffoldGraph, mp, lib, tol: int,
                      phys: np.ndarray, lift=None) -> None:
    """calculatePhysicalCoverage (pairedDBG.cpp:6552-6663): +1 over the
    inner span of every proper same-node pair within insert tolerance."""
    node_len, node_start, total = _layout(graph)
    if lift is None:
        lift = graph.lift_arrays()
    avg_ins = int(lib.average_insert)
    inner = int(min(lib.average_length, avg_ins / 3))
    f_sid, f_off, _fp, r_sid, r_off, _rp, both = _lift_pairs(graph, mp, lift)

    same = both & (f_sid == -r_sid)
    fwd_proper = same & (f_sid > 0) & (f_off < r_off)
    rev_proper = same & (r_sid > 0) & (r_off < f_off)
    ins = np.where(fwd_proper, r_off - f_off + 1,
                   np.where(rev_proper, f_off - r_off + 1, 0))
    keep = (fwd_proper | rev_proper) & (np.abs(ins - avg_ins) <= tol)
    if not keep.any():
        return
    ni = np.abs(f_sid[keep]) - 1
    lo = np.clip(np.minimum(f_off[keep], r_off[keep]), 0, node_len[ni] - 1)
    hi = np.clip(np.maximum(f_off[keep], r_off[keep]), 0, node_len[ni] - 1)
    lo = np.minimum(lo + inner, node_len[ni] - 1)
    hi = np.maximum(hi - inner, 0)
    _accumulate_ranges(total, node_start[ni] + lo, node_start[ni] + hi, phys)


def long_read_physical_coverage(graph: ScaffoldGraph, read_records,
                                phys: np.ndarray, lift=None) -> None:
    """calculateLongReadPhysicalCoverage (pairedDBG.cpp:6665-6759): per read
    and node, merge target ranges (gap <= read length) and +1 over the
    longest merged run."""
    node_len, node_start, total = _layout(graph)
    if lift is None:
        lift = graph.lift_arrays()
    nid_of, cst, _part, clen = lift
    g_lo, g_hi = [], []
    for _name, (read_len, recs) in read_records.items():
        by_node: dict[int, list] = {}
        for r in recs:
            ci = abs(r.position_id) - 1
            nid = int(nid_of[ci])
            if nid == 0:
                continue
            ni = abs(nid) - 1
            ts, te = r.t_start, r.t_end
            if nid < 0:
                ts = clen[ci] - ts - 1
                te = clen[ci] - te - 1
            ts += cst[ci]
            te += cst[ci]
            if ts > te:
                ts, te = te, ts
            ts = int(np.clip(ts, 0, node_len[ni] - 1))
            te = int(np.clip(te, 0, node_len[ni] - 1))
            by_node.setdefault(ni, []).append((ts, te))
        for ni, ranges in by_node.items():
            ranges.sort()
            cur_s, cur_e = ranges[0]
            max_s, max_e = cur_s, cur_e
            pre_e = cur_e
            for ls, le in ranges[1:]:
                if ls - pre_e + 1 > read_len:
                    if cur_e - cur_s > max_e - max_s:
                        max_s, max_e = cur_s, cur_e
                    cur_s, cur_e = ls, le
                else:
                    cur_s = min(cur_s, ls)
                    cur_e = max(cur_e, le)
                pre_e = le
            if cur_e - cur_s > max_e - max_s:
                max_s, max_e = cur_s, cur_e
            g_lo.append(node_start[ni] + max_s)
            g_hi.append(node_start[ni] + max_e)
    if g_lo:
        _accumulate_ranges(total, np.array(g_lo), np.array(g_hi), phys)


def gap_flags(graph: ScaffoldGraph) -> np.ndarray:
    """node2GapFlagsUnmappableContig (pairedDBG.cpp:7140-7162): 1 for every
    base not covered by a placed contig, or covered by an N base."""
    node_len, node_start, total = _layout(graph)
    flags = np.ones(total, dtype=np.int8)
    for ni, n in enumerate(graph.node):
        base = node_start[ni]
        for cid, st, _ed in n.contigs:
            ci = abs(cid) - 1
            if graph.contig_pos_id[ci] == 0:
                continue
            c = graph.contig[ci]
            seg = c if cid > 0 else c[::-1]
            end = min(st + len(c), node_len[ni])
            flags[base + st: base + end] = (seg[: end - st] == 4)
    return flags


def compensate_gap_rate(graph: ScaffoldGraph, phys: np.ndarray,
                        window: int) -> None:
    """compensatePhysicalCoverageBasedOnGapRate (pairedDBG.cpp:6761-6793):
    scale coverage up where the surrounding window is gap-rich (integer
    arithmetic preserved)."""
    node_len, node_start, _total = _layout(graph)
    flags = gap_flags(graph)
    half = window // 2
    for ni in range(len(graph.node)):
        L = int(node_len[ni])
        if L == 0:
            continue
        f = flags[node_start[ni]: node_start[ni] + L]
        padded = np.ones(L + window, dtype=np.int64)
        padded[half: half + L] = f
        csum = np.zeros(L + window + 1, dtype=np.int64)
        np.cumsum(padded, out=csum[1:])
        seg = phys[node_start[ni]: node_start[ni] + L]
        n_gap0 = int(csum[window] - csum[0])
        first = (seg[0] * (window // n_gap0)) if n_gap0 > 0 else 0
        n_gap = csum[window + 1: window + L] - csum[1: L]
        seg[1:] = seg[1:] * (window + 1) // (window - n_gap + 1)
        seg[0] = first


def diff_coverage(graph: ScaffoldGraph, mp, lib, length_threshold: int,
                  tol: int, diff: np.ndarray, lift=None) -> None:
    """calculateDiffCoverage (pairedDBG.cpp:6796-6940): pairs whose mates
    land on different nodes vote +1 over the window where the mate was
    expected."""
    node_len, node_start, total = _layout(graph)
    if lift is None:
        lift = graph.lift_arrays()
    avg_ins = int(lib.average_insert)
    inner = int(min(lib.average_length, avg_ins / 3))
    f_sid, f_off, _fp, r_sid, r_off, _rp, both = _lift_pairs(graph, mp, lift)
    conflict = both & (np.abs(f_sid) != np.abs(r_sid))
    if not conflict.any():
        return
    for sid, off, other in ((f_sid, f_off, r_sid), (r_sid, r_off, f_sid)):
        sel = conflict & (node_len[np.abs(other) - 1] >= length_threshold)
        ni = np.abs(sid[sel]) - 1
        o = off[sel]
        pos = sid[sel] > 0
        lo = np.where(pos, o + inner, o - inner - avg_ins + 1)
        hi = np.where(pos, o + inner + avg_ins, o - inner)
        lo = np.clip(lo, 0, node_len[ni] - 1)
        hi = np.clip(hi, 0, node_len[ni] - 1)
        _accumulate_ranges(total, node_start[ni] + lo, node_start[ni] + hi,
                           diff)


def long_read_diff_coverage(graph: ScaffoldGraph, read_records,
                            length_threshold: int, diff: np.ndarray,
                            lift=None) -> None:
    """calculateLongReadDiffCoverage (pairedDBG.cpp:6943-7057): best-scored
    position per node per read; every cross-node position pair votes."""
    node_len, node_start, total = _layout(graph)
    if lift is None:
        lift = graph.lift_arrays()
    nid_of, cst, _part, clen = lift
    g_lo, g_hi = [], []
    for _name, (read_len, recs) in read_records.items():
        best: dict[int, tuple[int, int]] = {}  # signed node id -> (off, score)
        for r in recs:
            ci = abs(r.position_id) - 1
            nid = int(nid_of[ci])
            if nid == 0:
                continue
            sid = nid if r.position_id > 0 else -nid
            ts = r.t_start
            if nid < 0:
                ts = clen[ci] - ts - 1
            ts = int(np.clip(ts + cst[ci], 0, node_len[abs(sid) - 1] - 1))
            cur = best.get(sid)
            if cur is None or cur[1] < r.score:
                best[sid] = (ts, r.score)
        if len(best) <= 1:
            continue
        items = list(best.items())
        half_ins = 0
        # averageInsSize for long reads = average read length / 2
        half_ins = read_len // 2
        for i in range(len(items) - 1):
            for j in range(i + 1, len(items)):
                (sid_a, (off_a, _)), (sid_b, (off_b, _)) = items[i], items[j]
                if sid_a == -sid_b and abs(off_a - off_b) <= 2 * read_len:
                    continue
                for sid, off, other in ((sid_a, off_a, sid_b),
                                        (sid_b, off_b, sid_a)):
                    ni = abs(sid) - 1
                    if node_len[abs(other) - 1] < length_threshold:
                        continue
                    if sid > 0:
                        lo, hi = off, min(off + half_ins, node_len[ni] - 1)
                    else:
                        lo, hi = max(off - half_ins + 1, 0), off
                    g_lo.append(node_start[ni] + max(lo, 0))
                    g_hi.append(node_start[ni] + min(hi, node_len[ni] - 1))
    if g_lo:
        _accumulate_ranges(total, np.array(g_lo), np.array(g_hi), diff)


def detect_breakpoints(phys: np.ndarray, diff: np.ndarray,
                       edge: int) -> np.ndarray:
    """detectBreakpointBasedOnCoverage (pairedDBG.cpp:7078-7100) on one
    node's tracks; returns a bool mask."""
    bp = np.zeros(len(phys), dtype=bool)
    if len(phys) <= 2 * edge:
        return bp
    interior = phys[edge: len(phys) - edge]
    median = int(np.partition(interior, len(interior) // 2)[len(interior) // 2])
    if median < MIN_MEDIAN_COVERAGE:
        return bp
    sl = slice(edge, len(phys) - edge)
    bp[sl] = ((phys[sl] < MIN_COVERAGE_RATE * median)
              & (diff[sl] > MAX_DIFF_COVERAGE_RATE * phys[sl])
              & (diff[sl] > MIN_DIFF_COVERAGE))
    return bp


def divide_node_based_on_coverage(graph: ScaffoldGraph, phys: np.ndarray,
                                  diff: np.ndarray, edge: int) -> int:
    """divideNodeBasedOnCoverage (pairedDBG.cpp:7165-7294): split scaffold
    nodes at contig boundaries flanked by base breakpoints; record unlink
    contig pairs and previous parents so rebuilt graphs don't re-join.

    Deviation (documented): the reference populates contigUnlinkSet with
    node-id values due to an apparent index mixup (pairedDBG.cpp:7240-7257
    inserts contigPositionInScaffold ids where contig indices are read back
    at :99); we record the intended *contig index* pairs across the cut.
    """
    node_len, node_start, _total = _layout(graph)
    new_nodes: list[list] = []
    num_divided = 0
    prev_parent = np.zeros(graph.num_contig, dtype=np.int64)
    for ni, n in enumerate(graph.node):
        if len(n.contigs) <= 1 or node_len[ni] <= 2 * edge:
            new_nodes.append(list(n.contigs))
            continue
        seg = slice(node_start[ni], node_start[ni] + node_len[ni])
        bp = detect_breakpoints(phys[seg], diff[seg], edge)
        if not bp.any():
            new_nodes.append(list(n.contigs))
            continue
        # contig-boundary check (detectContigBoundaryBreakpoints)
        nc = len(n.contigs)
        broken = np.zeros(nc + 1, dtype=bool)
        broken[-1] = True
        cut = False
        for i in range(1, nc):
            pid, pst, ped = n.contigs[i - 1]
            cid, cst, ced = n.contigs[i]
            lo = max(ped - min(edge, (ped - pst) // 2), 0)
            hi = min(cst + min(edge, (ced - cst) // 2), node_len[ni])
            if lo < hi and bp[lo:hi].any():
                broken[i] = True
                cut = True
        if not cut:
            new_nodes.append(list(n.contigs))
            continue
        num_divided += 1
        pieces: list[list] = []
        j = 0
        while j < nc:
            start = n.contigs[j][1]
            k = j
            while (not broken[j + 1] and j < nc - 1
                   and n.contigs[j + 1][2] >= start):
                j += 1
            j += 1
            pieces.append([(cid, st - start, ed - start)
                           for cid, st, ed in n.contigs[k:j]])
        for pi, piece in enumerate(pieces):
            new_nodes.append(piece)
            for cid, _s, _e in piece:
                ci1 = abs(cid) - 1
                if graph.contig_pos_id[ci1] != 0:
                    prev_parent[ci1] = ni + 1
                for qi, other in enumerate(pieces):
                    if qi == pi:
                        continue
                    for cid2, _s2, _e2 in other:
                        ci2 = abs(cid2) - 1
                        graph.contig_unlink.add(
                            min(ci1, ci2) * graph.num_contig + max(ci1, ci2))
    graph._remake(new_nodes)
    graph.contig_prev_parent = prev_parent
    LOG.counter("NUM_DIVIDED_ERROR_CANDIDATES_BASE_LEVEL", num_divided)
    return num_divided


def divide_erroneous_node_base_level(graph: ScaffoldGraph, libs, mapped,
                                     read_records=None,
                                     min_tol_factor: int = 2) -> int:
    """divideErroneousNodeBaseLevel (pairedDBG.cpp:6480-6548) for the
    consensus path (bubbleFlag=False, longLibraryFlag=True,
    storeOnlyFlag=False)."""
    LOG.info("dividing erroneous scaffolds based on base-level coverages ...")
    _node_len, _node_start, total = _layout(graph)
    phys = np.zeros(total, dtype=np.int64)
    diff = np.zeros(total, dtype=np.int64)
    lift = graph.lift_arrays()
    for lib, mp in zip(libs, mapped):
        tol = int(min_tol_factor * lib.sd_insert)
        physical_coverage(graph, mp, lib, tol, phys, lift)
        compensate_gap_rate(graph, phys, 2 * int(lib.average_insert))
        diff_coverage(graph, mp, lib, int(lib.average_insert),
                      int(lib.average_insert), diff, lift)
    if read_records:
        avg_len = int(np.mean([rl for rl, _ in read_records.values()]))
        long_read_physical_coverage(graph, read_records, phys, lift)
        long_read_diff_coverage(graph, read_records, avg_len, diff, lift)
    edge = int(libs[0].average_insert) if libs else 0
    return divide_node_based_on_coverage(graph, phys, diff, edge)


# ---------------------------------------------------------------------------
# junction-level division (divideErroneousNode, pairedDBG.cpp:5660)
# ---------------------------------------------------------------------------

def _junction_layout(graph: ScaffoldGraph):
    nj = np.array([max(len(n.contigs) - 1, 0) for n in graph.node],
                  dtype=np.int64)
    starts = np.zeros(len(nj) + 1, dtype=np.int64)
    np.cumsum(nj, out=starts[1:])
    return nj, starts[:-1], int(starts[-1])


def count_pairs_spanning_gap(graph: ScaffoldGraph, mp, lib, tol: int,
                             spanning: np.ndarray, lift=None) -> None:
    """countPairsSpanningGap (pairedDBG.cpp:5020-5100): proper same-node
    pairs vote +1 on every junction between their two parts."""
    nj, jstart, total = _junction_layout(graph)
    if lift is None:
        lift = graph.lift_arrays()
    avg_ins = int(lib.average_insert)
    f_sid, f_off, f_part, r_sid, r_off, r_part, both = \
        _lift_pairs(graph, mp, lift)
    keep = both & (f_sid == -r_sid) \
        & (np.abs(np.abs(f_off - r_off) - avg_ins) <= tol)
    if not keep.any():
        return
    ni = np.abs(f_sid[keep]) - 1
    lo = np.minimum(f_part[keep], r_part[keep])
    hi = np.maximum(f_part[keep], r_part[keep])
    ok = hi > lo
    d = np.zeros(total + 1, dtype=np.int64)
    np.add.at(d, jstart[ni[ok]] + lo[ok], 1)
    np.add.at(d, jstart[ni[ok]] + hi[ok], -1)
    spanning += np.cumsum(d[:total])


def count_links_inside_contigs(graph: ScaffoldGraph, mp, lib, tol: int,
                               erroneous: np.ndarray, lift=None) -> None:
    """countLinksInsideContigs (pairedDBG.cpp:5171-5400): pairs that are
    NOT properly joined in a node vote on junctions within insert reach of
    each end."""
    nj, jstart, _total = _junction_layout(graph)
    if lift is None:
        lift = graph.lift_arrays()
    avg_ins = int(lib.average_insert)
    node_len = np.array([n.length for n in graph.node], dtype=np.int64)
    nid_of, cst, _part, clen = lift
    f_sid, f_off, f_part, r_sid, r_off, r_part, both = \
        _lift_pairs(graph, mp, lift)
    over_f = np.where(f_sid > 0, node_len[np.abs(f_sid) - 1] - f_off, f_off)
    over_r = np.where(r_sid > 0, node_len[np.abs(r_sid) - 1] - r_off, r_off)
    bad = both & ~((f_sid == -r_sid) | (over_f + over_r <= avg_ins + tol))
    if not bad.any():
        return
    # contig-level overhang: the mate should have been within reach
    cf = np.abs(mp.fwd_id) - 1
    cr = np.abs(mp.rev_id) - 1
    cov_f = np.where(mp.fwd_id > 0, clen[cf] - mp.fwd_off, mp.fwd_off)
    cov_r = np.where(mp.rev_id > 0, clen[cr] - mp.rev_off, mp.rev_off)
    for sid, off, part, covh in ((f_sid, f_off, f_part, cov_f),
                                 (r_sid, r_off, r_part, cov_r)):
        sel = np.nonzero(bad & (covh > avg_ins + tol))[0]
        for k in sel:
            ni = abs(int(sid[k])) - 1
            n = graph.node[ni]
            p = int(part[k])
            o = int(off[k])
            if sid[k] > 0:
                for i in range(p, len(n.contigs) - 1):
                    if n.contigs[i][2] - o <= avg_ins:
                        erroneous[jstart[ni] + i] += 1
                    else:
                        break
            else:
                for i in range(p, 0, -1):
                    if o - n.contigs[i][1] <= avg_ins:
                        erroneous[jstart[ni] + i - 1] += 1
                    else:
                        break


def divide_erroneous_node(graph: ScaffoldGraph, libs, mapped,
                          min_link: int, mode: str = "default",
                          max_gap_size: int = 0,
                          min_tol_factor: int = 2) -> int:
    """divideErroneousNode (pairedDBG.cpp:5660-5724) + divideErroneousLink
    (:4923-5018). mode: 'default' | 'gap' (SWITCH needs bubble tracking)."""
    LOG.info("dividing erroneous scaffolds...")
    nj, jstart, total = _junction_layout(graph)
    spanning = np.zeros(total, dtype=np.int64)
    erroneous = np.zeros(total, dtype=np.int64)
    lift = graph.lift_arrays()
    for lib, mp in zip(libs, mapped):
        tol = int(min_tol_factor * lib.sd_insert)
        count_pairs_spanning_gap(graph, mp, lib, tol, spanning, lift)
        count_links_inside_contigs(graph, mp, lib, tol, erroneous, lift)

    new_nodes: list[list] = []
    num_divided = 0
    prev_parent = np.zeros(graph.num_contig, dtype=np.int64)
    for ni, n in enumerate(graph.node):
        nc = len(n.contigs)
        if nc <= 1:
            new_nodes.append(list(n.contigs))
            continue
        broken = np.zeros(nc + 1, dtype=bool)
        broken[-1] = True
        cut = False
        for j in range(nc - 1):
            sp = spanning[jstart[ni] + j]
            er = erroneous[jstart[ni] + j]
            if mode == "gap":
                if (n.contigs[j][2] - n.contigs[j + 1][1] < max_gap_size
                        or er < min_link):
                    continue
            else:
                if er <= sp:
                    continue
            broken[j + 1] = True
            cut = True
            num_divided += 1
        if not cut:
            new_nodes.append(list(n.contigs))
            continue
        j = 0
        while j < nc:
            start = n.contigs[j][1]
            k = j
            while not broken[j + 1]:
                j += 1
            j += 1
            new_nodes.append([(cid, st - start, ed - start)
                              for cid, st, ed in n.contigs[k:j]])
        for cid, _s, _e in n.contigs:
            ci = abs(cid) - 1
            if graph.contig_pos_id[ci] != 0:
                prev_parent[ci] = ni + 1
    graph._remake(new_nodes)
    graph.contig_prev_parent = prev_parent
    LOG.counter("NUM_DIVIDED_ERROR_CANDIDATES", num_divided)
    return num_divided


# ---------------------------------------------------------------------------
# guide-graph division (pairedDBG.cpp:3905-4005)
# ---------------------------------------------------------------------------
# Note on reference status: divideUsingGuideGraph / extendUsingGuideGraph
# are declared in pairedDBG.h:261-263 but have NO callers in any command
# flow of v1.3.2 (checked: no call sites outside pairedDBG.cpp), and
# extendUsingGuideGraph (:4068-4165) is abandoned debug code — its entire
# division logic is commented out and it only prints layout diagnostics.
# The real algorithm, divideUsingGuideGraph, is implemented here for
# inventory completeness and exposed for guided division experiments.

def set_corresponding_node_position(graph: ScaffoldGraph,
                                    parts: list) -> list[tuple[int, int]]:
    """setCorrespondingNodePosition (pairedDBG.cpp:3996-4005): map each
    layout part's contig to its (signed node id, offset) in `graph`,
    falling back to the opposite bubble contig's position."""
    out: list[tuple[int, int]] = []
    for cid, _st, _ed in parts:
        ci = abs(cid) - 1
        sgn = 1 if cid > 0 else -1
        pid = int(graph.contig_pos_id[ci])
        if pid != 0:
            out.append((sgn * pid, int(graph.contig_pos_off[ci])))
            continue
        opp = int(graph.opposite_bubble_contig_id[ci])
        if opp != 0 and graph.contig_pos_id[abs(opp) - 1] != 0:
            oi = abs(opp) - 1
            out.append((sgn * int(graph.contig_pos_id[oi]),
                        int(graph.contig_pos_off[oi])))
        else:
            out.append((0, 0))
    return out


def _max_length_contig_id(ids: list[int], node_lengths: np.ndarray,
                          start: int, end: int) -> int:
    """maxLengthContigID (pairedDBG.cpp): the id whose occurrences in
    [start, end) carry the largest total node length."""
    acc: dict[int, int] = {}
    for i in range(start, end):
        v = ids[i]
        if v == 0:
            continue
        acc[v] = acc.get(v, 0) + int(node_lengths[abs(v) - 1])
    best_id, best = 0, 0
    for v, c in acc.items():
        if c > best:
            best_id, best = v, c
    return best_id


def _fill_majority_id_run(ids: list[int], node_lengths: np.ndarray,
                          ends: tuple[int, int],
                          score_factor: float) -> tuple[int, int]:
    """fillMajorityIDRun (pairedDBG.cpp:4007-4048 region): trim the range
    to the maximal-scoring run of the majority id and overwrite it."""
    max_id = _max_length_contig_id(ids, node_lengths, ends[0], ends[1])
    if max_id == 0:
        return ends
    lo, hi = ends
    for i in range(ends[0], ends[1]):
        if ids[i] == max_id:
            lo = i
            break
    for i in range(ends[1] - 1, ends[0] - 1, -1):
        if ids[i] == max_id:
            hi = i + 1
            break
    # prefix-score trims — exact fillMajorityIDRun recurrence
    # (pairedDBG.cpp:2987-3021): maxScore stays 0, so a positive running
    # score clamps back to 0 and records the cut position
    score = max_score = 0
    cut = lo
    for i in range(lo, hi):
        if score > max_score:
            score = max_score
            cut = i
        if ids[i] != 0:
            if ids[i] == max_id:
                score -= int(node_lengths[abs(ids[i]) - 1])
            else:
                score += int(node_lengths[abs(ids[i]) - 1] * score_factor)
    lo = cut
    score = max_score = 0
    cut = hi - 1
    for i in range(hi - 1, lo, -1):
        if score > max_score:
            score = max_score
            cut = i
        if ids[i] != 0:
            if ids[i] == max_id:
                score -= int(node_lengths[abs(ids[i]) - 1])
            else:
                score += int(node_lengths[abs(ids[i]) - 1] * score_factor)
    hi = cut + 1
    for i in range(lo, hi):
        ids[i] = max_id
    return lo, hi


def smooth_node_id_vector(ids: list[int], node_lengths: np.ndarray,
                          score_factor: float = 0.0) -> None:
    """smoothNodeIDVector (pairedDBG.cpp:4050-4066): recursively fill the
    majority-id run, then recurse on the flanks outside it."""
    stack = [(0, len(ids))]
    while stack:
        ends = stack.pop()
        new_ends = _fill_majority_id_run(ids, node_lengths, ends,
                                         score_factor)
        if new_ends != ends:
            stack.append((ends[0], new_ends[0]))
            stack.append((new_ends[1], ends[1]))


def divide_using_guide_graph(graph: ScaffoldGraph, guide: ScaffoldGraph,
                             bubble_divide: bool = False) -> int:
    """divideUsingGuideGraph (pairedDBG.cpp:3905-3993): walk each guide
    layout through `graph`'s current scaffolds; where a part's actual node
    disagrees with the smoothed (majority) node over the layout, mark a
    breakpoint at that contig boundary; then split every node at its
    breakpoints, emitting each piece only if it contains a not-yet-used
    contig (uniqueFlag), and remake.

    Contig-level bubble state (DBG_CONTIG_*_BUBBLE in the reference) is
    approximated by opposite_bubble_contig_id != 0 — the repo tracks
    bubble pairing at contig granularity through that array.
    """
    from .hetero import set_opposite_bubble_node_ids

    set_opposite_bubble_node_ids(graph)
    node_lengths = np.array([n.length for n in graph.node], dtype=np.int64)

    bp = [np.zeros(len(n.contigs) + 1, dtype=bool) for n in graph.node]
    for f in bp:
        f[0] = f[-1] = True

    def contig_is_bubble(ci: int) -> bool:
        return graph.opposite_bubble_contig_id[ci] != 0

    n_break = 0
    for gnode in guide.node:
        parts = gnode.contigs
        alt = set_corresponding_node_position(graph, parts)
        smoothed = [a[0] for a in alt]
        smooth_node_id_vector(smoothed, node_lengths)
        pre_id = 0
        for i, (aid, aoff) in enumerate(alt):
            if (pre_id != aid and smoothed[i] != 0 and aid != 0
                    and smoothed[i] != aid):
                ci1 = abs(parts[i][0]) - 1
                anode = graph.node[abs(aid) - 1]
                ci2 = abs(anode.contigs[aoff][0]) - 1
                if bubble_divide or not (contig_is_bubble(ci1)
                                         or contig_is_bubble(ci2)):
                    pid1 = int(graph.contig_pos_id[ci1])
                    if pid1 != 0:
                        bp[abs(pid1) - 1][graph.contig_pos_off[ci1]] = True
                    if aid > 0:
                        bp[abs(aid) - 1][aoff] = True
                    else:
                        bp[abs(aid) - 1][aoff + 1] = True
                    n_break += 1
            pre_id = aid

    num_used = np.zeros(graph.num_contig, dtype=np.int64)
    new_nodes: list[list] = []
    for ni, n in enumerate(graph.node):
        contigs = n.contigs
        i = 0
        while i < len(contigs):
            j = i
            while not bp[ni][i + 1]:
                i += 1
            i += 1
            piece = contigs[j:i]
            if any(num_used[abs(cid) - 1] == 0 for cid, _s, _e in piece):
                base = piece[0][1]
                new_nodes.append([(cid, st - base, ed - base)
                                  for cid, st, ed in piece])
                for cid, _s, _e in piece:
                    num_used[abs(cid) - 1] += 1
    graph._remake(new_nodes)
    LOG.counter("NUM_GUIDE_BREAKPOINTS", n_break)
    return n_break
