"""Graph simplification (counterpart of platanus_b_tpu/models/clean.py).

- cut_branch            <- BruijnGraph::cutBranch (graph.h:830-926)
- delete_erroneous      <- deleteErroneousStraightNode (graph.h:2033-2082)
- crush_bubble          <- crushBubble (graph.h:592-681)
- *_iterative drivers   <- graph.h:1830-1870, 2086-2106

The iterative tip/erroneous-node fixed points replay on the element graph
(_ChainSim, lifted unchanged from clean.py:558: numpy over unitigs and
junction k-mers) after one device labeling. Float32 coverage decisions use
float32 arithmetic on the same values as the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.align import edit_distance_batch
from ..utils.log import LOG
from .dbg import DBG, _mask_topo_core, unitig_count_sums

BUBBLE_COVERAGE_RATE = 1.5  # graph.h:283


@dataclass
class CrushedBubble:
    """A crushed bubble record for the _contigBubble.fa output."""

    seq: np.ndarray  # base codes, full branch (ulen + k - 1 bases)
    coverage: int


def _first_target(si, so, look, node):
    """First live (target, orient) of topo rows [look, :, node] (the
    end_attach / first_valid scan of the JAX kernels)."""
    tgt = torch.full_like(node, -1)
    tor = torch.zeros_like(node)
    found = torch.zeros(node.shape, dtype=torch.bool, device=node.device)
    for b in range(4):
        vb = torch.where(look == 0, si[0, b][node], si[1, b][node])
        ob = torch.where(look == 0, so[0, b][node], so[1, b][node])
        take = ~found & (vb >= 0)
        tgt = torch.where(take, vb, tgt)
        tor = torch.where(take, ob, tor)
        found = found | (vb >= 0)
    return tgt, tor


def _end_attach(si, so, outdeg, ends, side):
    i = ends >> 1
    o = ends & 1
    look = (1 - o) if side == 0 else o
    deg = torch.where(look == 0, outdeg[0][i], outdeg[1][i])
    tgt, tor = _first_target(si, so, look, i)
    attached = (deg == 1) & (tgt >= 0)
    return torch.where(attached, tgt, -1), torch.where(attached, tor, 0)


def _unitig_ends(dbg: DBG):
    """Per-unitig end attachments (clean.py:40), host arrays:
    {side: (junction node or -1, junction orientation)}."""
    u = dbg.label_unitigs()
    si, so, _out, od, _isj = dbg.topo_host()
    res = {}
    for side, ends in ((0, u.uhead), (1, u.utail)):
        i = ends >> 1
        o = ends & 1
        look = (1 - o) if side == 0 else o
        deg = od[i, look]
        b = np.argmax(si[i, look] >= 0, axis=-1)
        tgt = si[i, look, b]
        tgt_or = so[i, look, b]
        attached = (deg == 1) & (tgt >= 0)
        res[side] = (np.where(attached, tgt, -1),
                     np.where(attached, tgt_or, 0))
    return res


def _cut_branch_kill(dbg: DBG, branch_threshold: float):
    """clean.py:104 _cut_branch_kernel_core: node kill mask + count."""
    si, so, _out, outdeg, is_junction = dbg.topo
    lab = dbg.label_unitigs_device()
    n = dbg.n
    U = lab.num_u
    dev = dbg.device
    head_j, head_q = _end_attach(si, so, outdeg, lab.uhead, 0)
    tail_j, tail_q = _end_attach(si, so, outdeg, lab.utail, 1)
    tip = (lab.ulen <= dbg.k) & ((head_j >= 0) ^ (tail_j >= 0))
    jn = torch.where(head_j >= 0, head_j, tail_j).clamp(0, max(n - 1, 0))
    q = 1 - torch.where(head_j >= 0, head_q, tail_q)
    uidx = torch.arange(U, device=dev)
    maxcov = torch.zeros(U, dtype=torch.int64, device=dev)
    for b in range(4):
        tgt = torch.where(q == 0, si[0, b][jn], si[1, b][jn])
        t = tgt.clamp(0, max(n - 1, 0))
        tu = lab.uid[t]
        cov_u = torch.where(tu >= 0, lab.ucov[tu.clamp(0, max(U - 1, 0))], 0)
        cov = torch.where(is_junction[t], dbg.counts[t], cov_u)
        cov = torch.where((tgt >= 0) & (torch.where(tu >= 0, tu, -2) != uidx),
                          cov, 0)
        maxcov = torch.maximum(maxcov, cov)
    kill_u = tip & (lab.ucov.to(torch.float32)
                    <= maxcov.to(torch.float32)
                    * torch.tensor(branch_threshold, dtype=torch.float32))
    node_kill = (lab.uid >= 0) & kill_u[lab.uid.clamp(0, max(U - 1, 0))] \
        if U else torch.zeros(n, dtype=torch.bool, device=dev)
    return node_kill, int(kill_u.sum())


def cut_branch(dbg: DBG, branch_threshold: float = 0.5) -> int:
    """One tip-clipping round (graph.h:830-926): a unitig of <= k k-mers
    attached to a junction on exactly one side dies when its coverage <=
    branch_threshold * (max sibling branch coverage)."""
    node_kill, n_kill = _cut_branch_kill(dbg, branch_threshold)
    if n_kill:
        dbg.delete_nodes(node_kill)
    return n_kill


def delete_erroneous(dbg: DBG, length_cut: int, coverage_cut: float) -> int:
    """deleteErroneousStraightNode (graph.h:2033-2082): kill unitigs with
    ulen < length_cut AND coverage < coverage_cut."""
    lab = dbg.label_unitigs_device()
    kill_u = (lab.ulen < min(length_cut, 2**31 - 1)) & (
        lab.ucov.to(torch.float32)
        < torch.tensor(min(coverage_cut, 3.4e38), dtype=torch.float32))
    n_kill = int(kill_u.sum())
    if n_kill:
        dbg.delete_nodes((lab.uid >= 0)
                         & kill_u[lab.uid.clamp(0, max(lab.num_u - 1, 0))])
    return n_kill


def cut_branch_iterative(dbg: DBG, branch_threshold: float = 0.5) -> int:
    """cutBranchIterative (graph.h:1830-1845): fixed point of tip clipping,
    replayed on the element graph after one device labeling."""
    with LOG.stage("removing branches"):
        with LOG.stage("  chain pull"):
            sim = _ChainSim(dbg)
        with LOG.stage("  host replay"):
            total = rounds = 0
            while True:
                rounds += 1
                n = sim.cut_branch_round(branch_threshold)
                if n == 0:
                    break
                total += n
            LOG.count("rounds", rounds)
            LOG.count("elements", sim.ne)
        LOG.counter("NUM_CUT", total)
        if total:
            sim.apply()
    return total


def delete_erroneous_iterative(dbg: DBG, length_cut: int, coverage_cut: float,
                               branch_threshold: float = 0.5) -> int:
    """deleteErroneousStraightNodeIterative (graph.h:2086-2106)."""
    with LOG.stage("removing erroneous nodes"):
        with LOG.stage("  chain pull"):
            sim = _ChainSim(dbg)
        with LOG.stage("  host replay"):
            total = rounds = 0
            while True:
                rounds += 1
                n1 = sim.cut_branch_round(branch_threshold)
                n2 = sim.delete_erroneous_round(min(length_cut, 2**62),
                                                min(coverage_cut, 3.4e38))
                if n1 + n2 == 0:
                    break
                total += n1 + n2
            LOG.count("rounds", rounds)
            LOG.count("elements", sim.ne)
        LOG.counter("TOTAL_NUM_REMOVED_NODES", total)
        if total:
            sim.apply()
    return total


def crush_bubble(dbg: DBG, average_coverage: float,
                 bubble_threshold: float = 0.1,
                 crushed: list[CrushedBubble] | None = None) -> int:
    """One bubble-crush round (graph.h:592-681, clean.py:265).

    Branch pairs between the same junction pair whose summed coverage <=
    average_coverage * 1.5 + 0.5 and whose middle sections lie within edit
    distance (max_len + k - 1) * bubble_threshold + 0.5 are clustered; the
    max-coverage member of each cluster survives and absorbs the others'
    coverage. The edit distances run as one batch on the graph's device
    (the edit_distance kernel on CUDA).

    Three stages time a round: `  bubble pairs` (the labeling, the
    grouping by junction pair and the pair loop; counts `candidates`,
    branches with a junction at both ends, and `pairs`), `  bubble align`
    (the edit distances, where a pair needs them; count `aligned`) and
    `  bubble merge` (the clustering, the coverage absorption and the
    deletion; count `crushed`)."""
    k = dbg.k
    with LOG.stage("  bubble pairs"):
        LOG.count("candidates", 0)
        LOG.count("pairs", 0)
        u = dbg.label_unitigs()
        if u.num_unitigs == 0:
            return 0
        ends = _unitig_ends(dbg)
        head_j, _head_q = ends[0]
        tail_j, _tail_q = ends[1]

        both = (head_j >= 0) & (tail_j >= 0)
        cand = np.nonzero(both)[0]
        LOG.count("candidates", len(cand))
        if len(cand) == 0:
            return 0

        cov_threshold = min(int(average_coverage * BUBBLE_COVERAGE_RATE + 0.5), 0xFFFF)
        if average_coverage >= 0xFFFF:
            cov_threshold = 0xFFFF

        # group candidate branches by unordered junction pair
        ja = np.minimum(head_j[cand], tail_j[cand])
        jb = np.maximum(head_j[cand], tail_j[cand])
        order = np.lexsort((jb, ja))
        cand = cand[order]
        ja, jb = ja[order], jb[order]
        grp_new = np.ones(len(cand), dtype=bool)
        grp_new[1:] = (ja[1:] != ja[:-1]) | (jb[1:] != jb[:-1])
        grp_id = np.cumsum(grp_new) - 1
        grp_start = np.flatnonzero(grp_new)
        grp_end = np.append(grp_start[1:], len(cand))

        seqs, base_lens = dbg.unitig_sequences()

        def branch_seq(ui):
            # orient every branch from the smaller junction to the larger
            s = seqs[ui, : base_lens[ui]]
            if min(head_j[ui], tail_j[ui]) != head_j[ui]:
                s = (3 - s[::-1]) % 5
                s = np.where(s > 3, 4, s)
            return s

        pairs_a, pairs_b = [], []
        for g0, g1 in zip(grp_start, grp_end):
            members = cand[g0:g1]
            for x in range(len(members) - 1):
                for y in range(x + 1, len(members)):
                    u1, u2 = members[x], members[y]
                    if int(u.ucov[u1]) + int(u.ucov[u2]) > cov_threshold:
                        continue
                    pairs_a.append(u1)
                    pairs_b.append(u2)
        LOG.count("pairs", len(pairs_a))
        if not pairs_a:
            return 0
        del grp_id
    pairs_a = np.array(pairs_a)
    pairs_b = np.array(pairs_b)

    len_a = u.ulen[pairs_a].astype(np.int64)
    len_b = u.ulen[pairs_b].astype(np.int64)
    thr = ((np.maximum(len_a, len_b) + k - 1) * bubble_threshold + 0.5).astype(np.int64)

    # short rule (graph.h:627-636): min length + 1 <= k -> compare lengths
    short = np.minimum(len_a, len_b) + 1 <= k
    ok_short = short & (np.abs(len_a - len_b) <= thr)

    # long rule: edit distance of the middle sections, base positions
    # [k-1, ulen) of the ja->jb oriented branch
    need_align = ~short
    ok_align = np.zeros(len(pairs_a), dtype=bool)
    if need_align.any():
        with LOG.stage("  bubble align"):
            ai = np.nonzero(need_align)[0]
            LOG.count("aligned", len(ai))
            mida = [branch_seq(pairs_a[i])[k - 1: u.ulen[pairs_a[i]]] for i in ai]
            midb = [branch_seq(pairs_b[i])[k - 1: u.ulen[pairs_b[i]]] for i in ai]
            la = np.array([len(s) for s in mida], dtype=np.int32)
            lb = np.array([len(s) for s in midb], dtype=np.int32)
            A = np.zeros((len(ai), max(int(la.max()), 1)), dtype=np.uint8)
            B = np.zeros((len(ai), max(int(lb.max()), 1)), dtype=np.uint8)
            for r, s in enumerate(mida):
                A[r, : len(s)] = s
            for r, s in enumerate(midb):
                B[r, : len(s)] = s
            dev = dbg.device
            dist = edit_distance_batch(torch.from_numpy(A).to(dev),
                                       torch.from_numpy(la).to(dev),
                                       torch.from_numpy(B).to(dev),
                                       torch.from_numpy(lb).to(dev))
            ok_align[ai] = dist.cpu().numpy() <= thr[ai]

    ok = ok_short | ok_align
    if not ok.any():
        return 0

    with LOG.stage("  bubble merge"):
        # union-find clustering of ok pairs
        parent = np.arange(u.num_unitigs)

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for a, b in zip(pairs_a[ok], pairs_b[ok]):
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[rb] = ra

        roots = np.array([find(x) for x in range(u.num_unitigs)])
        clustered = np.nonzero(roots != np.arange(u.num_unitigs))[0]
        involved = np.unique(np.concatenate([clustered, roots[clustered]]))

        kill = np.zeros(u.num_unitigs, dtype=bool)
        cov_add = np.zeros(u.num_unitigs, dtype=np.float64)
        n_crush = 0
        for r in np.unique(roots[involved]):
            members = involved[roots[involved] == r]
            if len(members) < 2:
                continue
            winner = members[np.argmax(u.ucov[members])]
            for mbr in members:
                if mbr == winner:
                    continue
                # winner absorbs: cov += cov_m * len_m / len_winner (graph.h:660)
                cov_add[winner] += u.ucov[mbr] * u.ulen[mbr] / u.ulen[winner]
                kill[mbr] = True
                if crushed is not None:
                    crushed.append(CrushedBubble(
                        seq=seqs[mbr, : base_lens[mbr]].copy(),
                        coverage=int(u.ucov[mbr])))
                n_crush += 1

        if n_crush:
            # absorbed coverage goes into the member k-mer counts so the next
            # labeling reproduces the boosted average
            add_per_node = np.zeros(dbg.n, dtype=np.float64)
            sel = u.uid >= 0
            add_per_node[sel] = cov_add[u.uid[sel]]
            if add_per_node.any():
                new_counts = dbg.counts.cpu().numpy().astype(np.float64) + add_per_node
                dbg.counts = torch.from_numpy(
                    np.minimum(np.round(new_counts), 0xFFFF - 1).astype(np.int64)
                ).to(dbg.device)
            dbg.delete_unitigs(kill)
        LOG.count("crushed", n_crush)
    return n_crush


def crush_bubble_iterative(dbg: DBG, average_coverage: float,
                           bubble_threshold: float = 0.1,
                           crushed: list[CrushedBubble] | None = None) -> int:
    """crushBubbleIterative (graph.h:1852-1870)."""
    with LOG.stage("removing bubbles"):
        total = 0
        while True:
            n = crush_bubble(dbg, average_coverage, bubble_threshold, crushed)
            LOG.counter("NUM_REMOVED_BUBBLES", n)
            if n == 0:
                break
            total += n
        # the record keeps the call's total, not the last round's 0
        LOG.count("NUM_REMOVED_BUBBLES", total)
    return total


def _bubble_unitig_mask(dbg: DBG, u) -> np.ndarray:
    """Unitigs forming a parallel pair between one source and one sink
    junction (searchBubbleStructure grouping, graph.h:2386-2406)."""
    succ_idx, _so, _out, outdeg, is_junction = dbg.topo_host()
    num_u = u.num_unitigs
    mask = np.zeros(num_u, dtype=bool)
    if num_u == 0:
        return mask

    def single_junction_neighbor(oriented):
        i = oriented // 2
        o = oriented % 2
        if outdeg[i, o] != 1:
            return -1
        b = int(np.argmax(succ_idx[i, o] >= 0))
        s = int(succ_idx[i, o, b])
        return s if s >= 0 and is_junction[s] else -1

    pair_groups: dict[tuple[int, int], list[int]] = {}
    for r in range(num_u):
        src = single_junction_neighbor(int(u.uhead[r]) ^ 1)
        snk = single_junction_neighbor(int(u.utail[r]))
        if src < 0 or snk < 0:
            continue
        pair_groups.setdefault((src, snk), []).append(r)
        pair_groups.setdefault((snk, src), []).append(r)
    for members in pair_groups.values():
        uniq = set(members)
        if len(uniq) >= 2:
            for r in uniq:
                mask[r] = True
    return mask


def average_coverage_excluding_bubble(dbg: DBG) -> float:
    """getAverageCoverageExcludingBubble (graph.h:2375-2431):
    length-weighted mean coverage over non-bubble unitigs plus junction
    coverages (weight 1 each). The mask runs in the stage `  bubble mask`;
    the open stage gets the counts `unitigs` and `bubble_unitigs` (the
    mask's)."""
    u = dbg.label_unitigs()
    LOG.count("unitigs", u.num_unitigs)
    LOG.count("bubble_unitigs", 0)
    if u.num_unitigs == 0:
        return 0.0
    with LOG.stage("  bubble mask"):
        keep = ~_bubble_unitig_mask(dbg, u)
    LOG.count("bubble_unitigs", int((~keep).sum()))
    if not keep.any():
        keep = np.ones_like(keep)
    w = u.ulen[keep].astype(np.float64)
    s = float((u.ucov[keep] * w).sum())
    num = float(w.sum())
    _ji, jc = dbg.junction_info()
    s += float(np.asarray(jc, dtype=np.float64).sum())
    num += float(len(jc))
    return s / max(num, 1.0)


# ---------------------------------------------------------------------------
# element-level chain simulation: ONE device labeling feeds a host replay
# of the cutBranch / deleteErroneous fixed points
# ---------------------------------------------------------------------------

def _chain_pull(dbg: DBG):
    """clean.py:504 _chain_pull_kernel: per-unitig count sums (float32)
    and the end attachments of every unitig."""
    si, so, _out, od, _isj = dbg.topo
    lab = dbg.label_unitigs_device()
    csum = unitig_count_sums(lab.uid, dbg.counts, lab.num_u)
    hj, hq = _end_attach(si, so, od, lab.uhead, 0)
    tj, tq = _end_attach(si, so, od, lab.utail, 1)
    return csum, hj, hq, tj, tq


def _numpy_rank(prv):
    """Pointer-doubling list ranking in numpy over the element graph:
    (rank, head, leftover_live) like _doubling_rank."""
    m = len(prv)
    rank = np.where(prv >= 0, 1, 0).astype(np.int64)
    anchor = np.where(prv >= 0, prv, np.arange(m))
    ptr = prv.copy()
    for _ in range(max(int(np.ceil(np.log2(max(m, 2)))) + 1, 1)):
        if not (ptr >= 0).any():
            break
        has = ptr >= 0
        p = np.clip(ptr, 0, m - 1)
        rank = np.where(has, rank + rank[p], rank)
        anchor = np.where(has, anchor[p], anchor)
        ptr = np.where(has, ptr[p], ptr)
    return rank, anchor, ptr


class _ChainSim:
    """Host replay of the node-level cleaning fixed points at ELEMENT
    granularity (elements = initial unitigs + junction k-mers), lifted from
    clean.py:558. Only __init__ (which pulls from the device) and apply()
    (which pushes the deaths back) differ from the JAX package."""

    def __init__(self, dbg: DBG):
        self.dbg = dbg
        self.k = dbg.k
        lab = dbg.label_unitigs_device()
        si, so, _out, _od, isj = dbg.topo
        csum, hj, hq, tj, tq = _chain_pull(dbg)
        nu = lab.num_u
        self.nu = nu
        self.ulen = lab.ulen.cpu().numpy().astype(np.int64)
        self.ucsum = csum.cpu().numpy().astype(np.float64)
        j_nodes_d = torch.nonzero(isj)[:, 0]
        self.j_nodes = j_nodes_d.cpu().numpy().astype(np.int64)
        nj = len(self.j_nodes)
        self.nj = nj
        self.jcount = dbg.counts[j_nodes_d].cpu().numpy().astype(np.float64)
        jsi = si[:, :, j_nodes_d].cpu().numpy().transpose(2, 0, 1)
        jso = so[:, :, j_nodes_d].cpu().numpy().transpose(2, 0, 1)
        node2j = np.full(dbg.n, -1, np.int64)
        node2j[self.j_nodes] = np.arange(nj)
        uid_h = lab.uid.cpu().numpy()
        uhead_h = lab.uhead.cpu().numpy().astype(np.int64)

        def node_entry_to_elem(t, p):
            """(target node, entry orientation) -> (element, entry slot d)."""
            t = np.asarray(t, np.int64)
            p = np.asarray(p, np.int64)
            je = node2j[np.clip(t, 0, dbg.n - 1)]
            uu = uid_h[np.clip(t, 0, dbg.n - 1)].astype(np.int64)
            oriented = 2 * t + p
            is_head = (uu >= 0) & (oriented == uhead_h[np.clip(uu, 0, max(nu - 1, 0))])
            elem = np.where(t < 0, -1,
                            np.where(je >= 0, nu + je, uu))
            d = np.where(je >= 0, p, np.where(is_head, 0, 1))
            return elem, d

        # junction adjacency (element level)
        e, d = node_entry_to_elem(jsi.reshape(-1), jso.reshape(-1))
        self.jadj_e = np.where(jsi.reshape(-1) >= 0, e, -1).reshape(nj, 2, 4)
        self.jadj_d = d.reshape(nj, 2, 4)
        # unitig end attachments -> element refs (targets are junctions)
        hj_h = hj.cpu().numpy().astype(np.int64)
        tj_h = tj.cpu().numpy().astype(np.int64)
        self.uadj_e = np.full((nu, 2), -1, np.int64)   # [:,0] head, [:,1] tail
        self.uadj_d = np.zeros((nu, 2), np.int64)
        hj_e = node2j[np.clip(hj_h, 0, dbg.n - 1)]
        tj_e = node2j[np.clip(tj_h, 0, dbg.n - 1)]
        self.uadj_e[:, 0] = np.where((hj_h >= 0) & (hj_e >= 0), nu + hj_e, -1)
        self.uadj_d[:, 0] = hq.cpu().numpy().astype(np.int64)
        self.uadj_e[:, 1] = np.where((tj_h >= 0) & (tj_e >= 0), nu + tj_e, -1)
        self.uadj_d[:, 1] = tq.cpu().numpy().astype(np.int64)

        self.ne = nu + nj
        self.alive = np.ones(self.ne, bool)
        self.total_killed = 0

    # -- per-round structure ------------------------------------------------
    def _branching(self):
        """Live branching (junction-status) mask per element."""
        br = np.zeros(self.ne, bool)
        if self.nj:
            tgt_alive = (self.jadj_e >= 0) & \
                self.alive[np.clip(self.jadj_e, 0, self.ne - 1)]
            deg = tgt_alive.sum(axis=2)          # (nj, 2)
            br[self.nu:] = self.alive[self.nu:] & ((deg[:, 0] >= 2)
                                                   | (deg[:, 1] >= 2))
        return br

    def _chains(self, br):
        """Label chains over oriented element slots: per-slot chain ids and
        per-chain stats (len in k-mers, covsum, end attachments)."""
        ne, nu = self.ne, self.nu
        m = 2 * ne
        nxt = np.full(m, -1, np.int64)
        # unitig slots: (u, 0) leaves via tail, (u, 1) via head
        if nu:
            for d, side in ((0, 1), (1, 0)):
                te = self.uadj_e[:, side]
                td = self.uadj_d[:, side]
                ok = (te >= 0) & self.alive[np.clip(te, 0, ne - 1)] \
                    & ~br[np.clip(te, 0, ne - 1)] & self.alive[:nu]
                nxt[2 * np.arange(nu) + d] = np.where(ok, 2 * te + td, -1)
        # junction (non-branching) slots: unique live target per orientation
        if self.nj:
            tgt_alive = (self.jadj_e >= 0) & \
                self.alive[np.clip(self.jadj_e, 0, ne - 1)]
            deg = tgt_alive.sum(axis=2)
            b = np.argmax(tgt_alive, axis=2)                    # (nj, 2)
            te = np.take_along_axis(self.jadj_e, b[:, :, None],
                                    axis=2)[:, :, 0]
            td = np.take_along_axis(self.jadj_d, b[:, :, None],
                                    axis=2)[:, :, 0]
            src_ok = self.alive[nu:] & ~br[nu:]
            ok = src_ok[:, None] & (deg == 1) & (te >= 0) \
                & self.alive[np.clip(te, 0, ne - 1)] \
                & ~br[np.clip(te, 0, ne - 1)]
            idx = 2 * (nu + np.arange(self.nj))
            nxt[idx] = np.where(ok[:, 0], 2 * te[:, 0] + td[:, 0], -1)
            nxt[idx + 1] = np.where(ok[:, 1], 2 * te[:, 1] + td[:, 1], -1)
        slot_alive = np.repeat(self.alive & ~br, 2)
        nxt = np.where(slot_alive, nxt, -1)
        arange = np.arange(m)
        twin = arange ^ 1
        nt = nxt[twin]
        prv = np.where(nt >= 0, nt ^ 1, -1)
        prv = np.where(slot_alive, prv, -1)

        rank, head, leftover = _numpy_rank(prv)
        if (leftover >= 0).any():
            # cycles: deterministic cut (smallest oriented-pair id), then
            # re-rank — mirrors dbg._label_core's cycle cut
            in_cycle = leftover >= 0
            ea = np.where(nxt >= 0, np.minimum(arange, nxt ^ 1), m)
            eb = np.where(nxt >= 0, np.maximum(arange, nxt ^ 1), m)
            cyc_ptr = np.where(in_cycle, prv, -1)
            ma, mb = ea.copy(), eb.copy()
            ptr = cyc_ptr.copy()
            for _ in range(max(int(np.ceil(np.log2(max(m, 2)))) + 1, 1)):
                if not (ptr >= 0).any():
                    break
                has = ptr >= 0
                p = np.clip(ptr, 0, m - 1)
                better = has & ((ma[p] < ma) | ((ma[p] == ma)
                                                & (mb[p] < mb)))
                ma = np.where(better, ma[p], ma)
                mb = np.where(better, mb[p], mb)
                ptr = np.where(has, ptr[p], ptr)
            cut = in_cycle & (ea == ma) & (eb == mb)
            nxt2 = np.where(cut, -1, nxt)
            nt2 = nxt2[twin]
            prv = np.where(nt2 >= 0, nt2 ^ 1, -1)
            prv = np.where(slot_alive, prv, -1)
            rank, head, _left = _numpy_rank(prv)
            nxt = nxt2

        tail = head[twin] ^ 1
        is_head = slot_alive & (prv == -1)
        rep = is_head & (arange <= (tail ^ 1))
        heads = np.nonzero(rep)[0]
        cid_of_head = np.full(m, -1, np.int64)
        cid_of_head[heads] = np.arange(len(heads))
        cid = cid_of_head[head]
        use_twin = (cid < 0)
        cid = np.where(use_twin, cid_of_head[tail ^ 1], cid)
        chain_of = np.where(slot_alive, cid, -1)

        nch = len(heads)
        elem_len = np.concatenate([self.ulen,
                                   np.ones(self.nj, np.int64)])
        elem_cov = np.concatenate([self.ucsum, self.jcount])
        # per-chain stats: each ELEMENT contributes once
        e_cid = chain_of[2 * np.arange(ne)]
        e_cid = np.where(e_cid >= 0, e_cid, chain_of[2 * np.arange(ne) + 1])
        ch_len = np.zeros(nch + 1, np.int64)
        ch_cov = np.zeros(nch + 1, np.float64)
        sel = e_cid >= 0
        np.add.at(ch_len, np.where(sel, e_cid, nch), np.where(sel, elem_len, 0))
        np.add.at(ch_cov, np.where(sel, e_cid, nch), np.where(sel, elem_cov, 0.0))
        ch_len = ch_len[:nch]
        ch_cov = ch_cov[:nch]

        def raw_out(slots):
            """outgoing (elem, d) from oriented slots (end_attach
            semantics: deg==1 & target exists)."""
            e = slots >> 1
            d = slots & 1
            te = np.full(len(slots), -1, np.int64)
            td = np.zeros(len(slots), np.int64)
            uu = e < nu
            if uu.any():
                side = np.where(d[uu] == 0, 1, 0)
                te[uu] = self.uadj_e[e[uu], side]
                td[uu] = self.uadj_d[e[uu], side]
            jj = ~uu
            if jj.any():
                jl = e[jj] - nu
                tgt_alive = (self.jadj_e[jl, d[jj]] >= 0) & \
                    self.alive[np.clip(self.jadj_e[jl, d[jj]], 0, ne - 1)]
                deg = tgt_alive.sum(axis=1)
                b = np.argmax(tgt_alive, axis=1)
                t_e = self.jadj_e[jl, d[jj], b]
                t_d = self.jadj_d[jl, d[jj], b]
                one = deg == 1
                te[jj] = np.where(one, t_e, -1)
                td[jj] = np.where(one, t_d, 0)
            ok = (te >= 0) & self.alive[np.clip(te, 0, ne - 1)]
            return np.where(ok, te, -1), td

        ch_head_slot = heads
        ch_tail_slot = tail[heads]
        h_e, h_d = raw_out(ch_head_slot ^ 1)
        t_e, t_d = raw_out(ch_tail_slot)
        br_ok_h = (h_e >= 0) & br[np.clip(h_e, 0, ne - 1)]
        br_ok_t = (t_e >= 0) & br[np.clip(t_e, 0, ne - 1)]
        return {
            "nch": nch, "chain_of_elem": e_cid,
            "len": ch_len, "cov": ch_cov,
            "head_j": np.where(br_ok_h, h_e, -1), "head_q": h_d,
            "tail_j": np.where(br_ok_t, t_e, -1), "tail_q": t_d,
        }

    def _sibling_maxcov(self, ch, br, jn_elem, jq, exclude_chain):
        """Max branch coverage at junction element jn_elem on the side
        facing the tip (orientation 1-jq), excluding the tip's own chain."""
        maxcov = np.zeros(len(jn_elem), np.float64)
        if self.nj == 0:
            return maxcov
        jl = np.clip(jn_elem - self.nu, 0, self.nj - 1)
        q = 1 - jq
        ucov_chain = np.floor(ch["cov"] / np.maximum(ch["len"], 1) + 0.5)
        for b in range(4):
            te = self.jadj_e[jl, q, b]
            has = (te >= 0) & self.alive[np.clip(te, 0, self.ne - 1)]
            tcl = np.clip(te, 0, self.ne - 1)
            t_br = br[tcl]
            cov_j = np.where(te >= self.nu,
                             self.jcount[np.clip(te - self.nu, 0,
                                                 max(self.nj - 1, 0))], 0.0)
            t_chain = ch["chain_of_elem"][tcl]
            cov_u = np.where(t_chain >= 0,
                             ucov_chain[np.clip(t_chain, 0,
                                                max(ch["nch"] - 1, 0))], 0.0)
            cov = np.where(t_br, cov_j, cov_u)
            excl = (~t_br) & (t_chain == exclude_chain)
            cov = np.where(has & ~excl, cov, 0.0)
            maxcov = np.maximum(maxcov, cov)
        return maxcov

    def _kill_chains(self, ch, kill_mask):
        """Mark all member elements of killed chains dead."""
        e_cid = ch["chain_of_elem"]
        sel = (e_cid >= 0) & kill_mask[np.clip(e_cid, 0,
                                               max(ch["nch"] - 1, 0))]
        if sel.any():
            self.alive[sel] = False
        return int(kill_mask.sum())

    def cut_branch_round(self, branch_threshold: float) -> int:
        """One cutBranch decision+apply on the current element graph."""
        br = self._branching()
        ch = self._chains(br)
        if ch["nch"] == 0:
            return 0
        short = ch["len"] <= self.k
        one_side = (ch["head_j"] >= 0) ^ (ch["tail_j"] >= 0)
        tip = short & one_side
        jn = np.where(ch["head_j"] >= 0, ch["head_j"], ch["tail_j"])
        jq = np.where(ch["head_j"] >= 0, ch["head_q"], ch["tail_q"])
        maxcov = self._sibling_maxcov(ch, br, np.clip(jn, self.nu, None),
                                      jq, np.arange(ch["nch"]))
        ucov = np.floor(ch["cov"] / np.maximum(ch["len"], 1) + 0.5)
        kill = tip & (ucov.astype(np.float32)
                      <= (maxcov.astype(np.float32)
                          * np.float32(branch_threshold)))
        self._kill_chains(ch, kill)
        return int(kill.sum())

    def delete_erroneous_round(self, length_cut, coverage_cut) -> int:
        br = self._branching()
        ch = self._chains(br)
        if ch["nch"] == 0:
            return 0
        ucov = np.floor(ch["cov"] / np.maximum(ch["len"], 1) + 0.5)
        kill = (ch["len"] < length_cut) \
            & (ucov.astype(np.float32) < np.float32(coverage_cut))
        self._kill_chains(ch, kill)
        return int(kill.sum())

    def apply(self) -> int:
        """Push accumulated element deaths down to the nodes and refresh the
        topology by masking. Dead junction indices are unique, so the
        scatter has one writer per index."""
        dbg = self.dbg
        kill_u = ~self.alive[:self.nu]
        dead_j = self.j_nodes[~self.alive[self.nu:]]
        if not kill_u.any() and len(dead_j) == 0:
            return 0
        lab = dbg.label_unitigs_device()
        kill_u_dev = torch.from_numpy(kill_u).to(dbg.device)
        node_kill = (lab.uid >= 0) & kill_u_dev[lab.uid.clamp(0, max(self.nu - 1, 0))] \
            if self.nu else torch.zeros(dbg.n, dtype=torch.bool, device=dbg.device)
        if len(dead_j):
            node_kill[torch.from_numpy(dead_j).to(dbg.device)] = True
        dbg.alive = dbg.alive & ~node_kill
        si0, so0, _o, _od, _isj = dbg.topo
        dbg._topo = _mask_topo_core(si0, so0, dbg.alive)
        dbg._labels = None
        dbg._unitigs = None
        return 1
