"""Graph simplification (counterpart of platanus_b_tpu/models/clean.py).

- cut_branch            <- BruijnGraph::cutBranch (graph.h:830-926)
- delete_erroneous      <- deleteErroneousStraightNode (graph.h:2033-2082)
- crush_bubble          <- crushBubble (graph.h:592-681)
- *_iterative drivers   <- graph.h:1830-1870, 2086-2106

The iterative tip/erroneous-node fixed points replay on the element graph
(_ChainSim, clean.py:558's replay over unitigs and junction k-mers, on the
dbg's device) after one device labeling. Float32 coverage decisions use
float32 arithmetic on the same values as the JAX package; the chain sums
are of integer values, exact in float64 and int64 in any order.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.align import edit_distance_batch
from ..utils.log import LOG
from .dbg import DBG, _mask_topo_core, _rank_chains, unitig_count_sums

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


def _replay_counts(sim: _ChainSim, rounds: int) -> None:
    """The replay's counts on the open `  host replay` record: rounds,
    elements, the rankings that cut a cycle and the synchronizing reads."""
    LOG.count("rounds", rounds)
    LOG.count("elements", sim.ne)
    LOG.count("cycle_cuts", sim.cycle_cuts)
    LOG.count("reads", sim.reads)


def cut_branch_iterative(dbg: DBG, branch_threshold: float = 0.5) -> int:
    """cutBranchIterative (graph.h:1830-1845): fixed point of tip clipping,
    replayed on the element graph after one device labeling; one read of
    the card a round (besides the ranking's)."""
    with LOG.stage("removing branches"):
        with LOG.stage("  chain pull"):
            sim = _ChainSim(dbg)
        # the stage keeps its name, though the replay runs on dbg's device
        with LOG.stage("  host replay"):
            total = rounds = 0
            while True:
                rounds += 1
                n = sim.read(sim.cut_branch_round(branch_threshold))
                if n == 0:
                    break
                total += n
            _replay_counts(sim, rounds)
        LOG.counter("NUM_CUT", total)
        if total:
            sim.apply()
    return total


def delete_erroneous_iterative(dbg: DBG, length_cut: int, coverage_cut: float,
                               branch_threshold: float = 0.5) -> int:
    """deleteErroneousStraightNodeIterative (graph.h:2086-2106); one read
    of the card an iteration, the sum of its two rounds' kills."""
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
                n = sim.read(n1 + n2)
                if n == 0:
                    break
                total += n
            _replay_counts(sim, rounds)
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
# element-level chain simulation: ONE device labeling feeds a replay of the
# cutBranch / deleteErroneous fixed points on the dbg's device
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


class _ChainSim:
    """Replay of the node-level cleaning fixed points at ELEMENT
    granularity (elements = initial unitigs + junction k-mers), the JAX
    package's clean.py:558 on the dbg's device.

    Oriented slot 2e+d of element e leaves through adj_e[e, d] (element
    or -1) and adj_d[e, d] (the entry slot there): a junction's four
    extensions of orientation d, a unitig's one end attachment (slot 0
    leaves by its tail, slot 1 by its head). A chain is named by its head
    slot (the representative of its two strands), so per-chain tensors
    have one row a slot and need no chain count from the card. The host
    reads the card only for the junction list here, a ranking's cycle flag
    and each round's kill count; `reads` counts them."""

    def __init__(self, dbg: DBG):
        self.dbg = dbg
        self.k = dbg.k
        n = dbg.n
        lab = dbg.label_unitigs_device()
        si, so, _out, _od, isj = dbg.topo
        csum, hj, hq, tj, tq = _chain_pull(dbg)
        self.j_nodes = torch.nonzero(isj)[:, 0]
        self.reads = 1
        nu, nj = lab.num_u, self.j_nodes.shape[0]
        self.nu, self.nj, self.ne = nu, nj, nu + nj
        dev = dbg.device
        node2j = torch.full((n,), -1, dtype=torch.int64, device=dev)
        node2j.scatter_(0, self.j_nodes, torch.arange(nj, device=dev))

        # a node of no unitig reads the spare last slot
        uhead = torch.cat([lab.uhead, lab.uhead.new_full((1,), -1)])

        def node_entry_to_elem(t, p):
            """(target node, entry orientation) -> (element, entry slot d)."""
            tc = t.clamp(0, max(n - 1, 0))
            je = node2j[tc]
            uu = lab.uid[tc]
            is_head = (uu >= 0) & (2 * t + p == uhead[torch.where(uu >= 0, uu, nu)])
            elem = torch.where(t < 0, -1, torch.where(je >= 0, nu + je, uu))
            d = torch.where(je >= 0, p, torch.where(is_head, 0, 1))
            return elem, d

        # junction rows: (nj, 2, 4) from the node topology
        jsi = si[:, :, self.j_nodes].permute(2, 0, 1)
        je, jd = node_entry_to_elem(jsi, so[:, :, self.j_nodes].permute(2, 0, 1))
        je = torch.where(jsi >= 0, je, -1)
        # unitig rows: the end attachments (targets are junctions), the
        # tail's for slot 0 and the head's for slot 1, in column 0
        ends_e, ends_d = [], []
        for tgt, q in ((tj, tq), (hj, hq)):
            tje = node2j[tgt.clamp(0, max(n - 1, 0))]
            ends_e.append(torch.where((tgt >= 0) & (tje >= 0), nu + tje, -1))
            ends_d.append(q)
        ue = torch.full((nu, 2, 4), -1, dtype=torch.int64, device=dev)
        ud = torch.zeros((nu, 2, 4), dtype=torch.int64, device=dev)
        ue[:, :, 0] = torch.stack(ends_e, dim=1)
        ud[:, :, 0] = torch.stack(ends_d, dim=1)
        self.adj_e = torch.cat([ue, je])
        self.adj_d = torch.cat([ud, jd])
        self.elem_len = torch.cat([
            lab.ulen, torch.ones(nj, dtype=torch.int64, device=dev)])
        self.elem_cov = torch.cat([csum.to(torch.float64),
                                   dbg.counts[self.j_nodes].to(torch.float64)])
        self.alive = torch.ones(self.ne, dtype=torch.bool, device=dev)
        m = 2 * self.ne
        self.iters = (max(m, 2) - 1).bit_length() + 1
        self.cycle_cuts = 0

    def read(self, count: torch.Tensor) -> int:
        """A count to the host: one synchronizing read."""
        self.reads += 1
        return int(count)

    # -- per-round structure ------------------------------------------------
    def _chains(self):
        """Branching elements and the chains between them over oriented
        element slots: per slot, as the head slot of a chain, that chain's
        stats (len in k-mers, ucov, end attachments)."""
        ne, m = self.ne, 2 * self.ne
        dev = self.alive.device
        live = (self.adj_e >= 0) & self.alive[self.adj_e.clamp(min=0)]
        deg = live.sum(dim=2)                                   # (ne, 2)
        b = torch.argmax(live.to(torch.int8), dim=2, keepdim=True)
        te = torch.gather(self.adj_e, 2, b).reshape(-1)         # (m,)
        td = torch.gather(self.adj_d, 2, b).reshape(-1)
        br = self.alive & (deg >= 2).any(dim=1)
        one = deg.reshape(-1) == 1
        slot_alive = (self.alive & ~br)[:, None].expand(ne, 2).reshape(-1)
        nxt = torch.where(slot_alive & one & ~br[te.clamp(min=0)],
                          2 * te + td, -1)
        prv, _rank, head, cut = _rank_chains(nxt, self.iters)
        self.reads += 1                      # the ranking's cycle flag
        self.cycle_cuts += cut
        arange = torch.arange(m, device=dev)
        tail = head[arange ^ 1] ^ 1
        rep = slot_alive & (prv == -1) & (arange <= (tail ^ 1))
        # each live slot's chain: its head, or its twin chain's head
        cid = torch.where(rep[head], head, tail ^ 1)
        e_cid = torch.where(slot_alive, cid, -1)[0::2]           # (ne,)
        # per-chain stats: each ELEMENT contributes once
        slot = torch.where(e_cid >= 0, e_cid, m)
        ch_len = torch.zeros(m + 1, dtype=torch.int64, device=dev) \
            .index_add_(0, slot, self.elem_len)[:m]
        ch_cov = torch.zeros(m + 1, dtype=torch.float64, device=dev) \
            .index_add_(0, slot, self.elem_cov)[:m]
        # end attachments (end_attach semantics: deg==1 & target exists),
        # kept where the target is branching; the head leaves by its twin
        out_e = torch.where(one, te, -1)
        out_d = torch.where(one, td, 0)
        h_e, t_e = out_e[arange ^ 1], out_e[tail]
        return {
            "br": br, "rep": rep, "chain_of_elem": e_cid,
            "len": ch_len,
            "ucov": torch.floor(ch_cov / ch_len.clamp(min=1) + 0.5),
            "head_j": torch.where((h_e >= 0) & br[h_e.clamp(min=0)], h_e, -1),
            "head_q": out_d[arange ^ 1],
            "tail_j": torch.where((t_e >= 0) & br[t_e.clamp(min=0)], t_e, -1),
            "tail_q": out_d[tail],
        }

    def _sibling_maxcov(self, ch, jn_elem, jq):
        """Max branch coverage at junction element jn_elem on the side
        facing the tip (orientation 1-jq), excluding the tip's own chain."""
        br, e_cid = ch["br"], ch["chain_of_elem"]
        te = self.adj_e[jn_elem.clamp(0, self.ne - 1), 1 - jq]   # (m, 4)
        tcl = te.clamp(min=0)
        has = (te >= 0) & self.alive[tcl]
        t_br = br[tcl]
        t_chain = e_cid[tcl]
        cov_u = torch.where(t_chain >= 0, ch["ucov"][t_chain.clamp(min=0)], 0.0)
        cov = torch.where(t_br, self.elem_cov[tcl], cov_u)
        own = torch.arange(te.shape[0], device=te.device)[:, None]
        excl = ~t_br & (t_chain == own)
        return torch.where(has & ~excl, cov, 0.0).amax(dim=1)

    def _kill_chains(self, ch, kill):
        """Mark all member elements of killed chains dead; the count of
        killed chains, on the device."""
        e_cid = ch["chain_of_elem"]
        self.alive = self.alive & ~((e_cid >= 0) & kill[e_cid.clamp(min=0)])
        return kill.sum()

    def cut_branch_round(self, branch_threshold: float) -> torch.Tensor:
        """One cutBranch decision+apply on the current element graph."""
        ch = self._chains()
        short = ch["len"] <= self.k
        one_side = (ch["head_j"] >= 0) ^ (ch["tail_j"] >= 0)
        tip = ch["rep"] & short & one_side
        at_head = ch["head_j"] >= 0
        jn = torch.where(at_head, ch["head_j"], ch["tail_j"])
        jq = torch.where(at_head, ch["head_q"], ch["tail_q"])
        maxcov = self._sibling_maxcov(ch, jn, jq)
        kill = tip & (ch["ucov"].to(torch.float32)
                      <= (maxcov.to(torch.float32)
                          * torch.tensor(branch_threshold,
                                         dtype=torch.float32)))
        return self._kill_chains(ch, kill)

    def delete_erroneous_round(self, length_cut, coverage_cut) -> torch.Tensor:
        ch = self._chains()
        kill = ch["rep"] & (ch["len"] < length_cut) \
            & (ch["ucov"].to(torch.float32)
               < torch.tensor(coverage_cut, dtype=torch.float32))
        return self._kill_chains(ch, kill)

    def apply(self) -> None:
        """Push accumulated element deaths down to the nodes and refresh the
        topology by masking. Dead junction indices are unique, so the
        scatter has one writer per index."""
        dbg = self.dbg
        lab = dbg.label_unitigs_device()
        # a node of no unitig reads the spare last slot
        kill_u = torch.cat([~self.alive[:self.nu],
                            torch.zeros(1, dtype=torch.bool, device=dbg.device)])
        node_kill = kill_u[torch.where(lab.uid >= 0, lab.uid, self.nu)]
        node_kill.scatter_(0, self.j_nodes, ~self.alive[self.nu:])
        dbg.alive = dbg.alive & ~node_kill
        si0, so0, _o, _od, _isj = dbg.topo
        dbg._topo = _mask_topo_core(si0, so0, dbg.alive)
        dbg._labels = None
        dbg._unitigs = None
