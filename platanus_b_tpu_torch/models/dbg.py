"""De Bruijn graph on device tensors + pointer-doubling unitig labeling.

Counterpart of platanus_b_tpu/models/dbg.py. Node i is the i-th canonical
k-mer of the sorted table (node id = rank in sorted key order); oriented
node 2i+o is node i read forward (o=0) or reverse complemented (o=1).
The topology is kept in the JAX package's (2, 4, n) layout (orientation,
extension base, node). Unlike the JAX package the table is not padded to
a power-of-two capacity: every per-node tensor has exactly n rows.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from ..ops.kmer import kmer_to_codes
from ..ops.keys import (lanes_to_words, lex_le, num_words, revcomp_words,
                        shl2_words, words_to_lanes)
from ..ops.rank import cycle_min_pair, rank_from_prev
from ..ops.search import lookup

INVALID = -1


def _next_pow2(n: int, minimum: int = 1024) -> int:
    n = max(int(n), minimum)
    return 1 << (n - 1).bit_length()


def popcount4(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.int64)
    return (x & 1) + ((x >> 1) & 1) + ((x >> 2) & 1) + ((x >> 3) & 1)


def _out_bits(si: torch.Tensor) -> torch.Tensor:
    w = (1 << torch.arange(4, device=si.device))[None, :, None]
    return torch.where(si >= 0, w, 0).sum(dim=1)


def _adjacency(keys: torch.Tensor, alive: torch.Tensor, k: int):
    """dbg.py:107 _adjacency_kernel: the 8 extension queries of every node
    (2 orientations x 4 bases) looked up among the alive nodes.

    Returns (succ_idx (2,4,n) int64, succ_orient (2,4,n) int64, out (2,n),
    outdeg (2,n), is_junction (n,))."""
    n = keys.shape[0]
    W = num_words(k)
    words = lanes_to_words(keys, W)
    idx_rows, orient_rows = [], []
    for o in (0, 1):
        ok = words if o == 0 else revcomp_words(words, k)
        shifted = shl2_words(ok, k)
        for b in range(4):
            q = shifted.clone()
            q[:, -1] |= b
            rc = revcomp_words(q, k)
            is_fwd = lex_le(q, rc)
            canon = torch.where(is_fwd[:, None], q, rc)
            idx = lookup(keys, words_to_lanes(canon))
            ok_idx = (idx >= 0) & alive
            ok_idx = ok_idx & alive[idx.clamp(0, max(n - 1, 0))]
            idx_rows.append(torch.where(ok_idx, idx, INVALID))
            orient_rows.append(torch.where(is_fwd, 0, 1))
    succ_idx = torch.stack(idx_rows).reshape(2, 4, n)
    succ_orient = torch.stack(orient_rows).reshape(2, 4, n)
    out = _out_bits(succ_idx)
    outdeg = popcount4(out)
    is_junction = alive & ((outdeg[0] >= 2) | (outdeg[1] >= 2))
    return succ_idx, succ_orient, out, outdeg, is_junction


def _mask_topo_core(succ_idx, succ_orient, alive_new):
    """dbg.py:352: edges to dead targets and rows of dead sources vanish;
    junction status recomputes from the new degrees."""
    n = alive_new.shape[0]
    tgt_ok = (succ_idx >= 0) & alive_new[succ_idx.clamp(0, max(n - 1, 0))]
    ok = tgt_ok & alive_new[None, None, :]
    si = torch.where(ok, succ_idx, INVALID)
    so = torch.where(ok, succ_orient, 0)
    out = _out_bits(si)
    outdeg = popcount4(out)
    is_junction = alive_new & ((outdeg[0] >= 2) | (outdeg[1] >= 2))
    return si, so, out, outdeg, is_junction


@dataclass
class Labels:
    """Device labeling (dbg.py:226 _label_core outputs), trimmed to num_u."""

    uid: torch.Tensor       # (n,) unitig id per node, -1 junction/dead
    upos: torch.Tensor      # (n,) k-mer position within the unitig
    uorient: torch.Tensor   # (n,) orientation of the node as traversed
    num_u: int
    ulen: torch.Tensor      # (U,) k-mers per unitig
    ucov: torch.Tensor      # (U,) floor(sum(counts)/ulen + 0.5), float32 math
    uhead: torch.Tensor     # (U,) oriented id of the first k-mer
    utail: torch.Tensor     # (U,) oriented id of the last k-mer


def _per_unitig_sum(uid: torch.Tensor, values: torch.Tensor,
                    num_u: int) -> torch.Tensor:
    """(num_u,) int64 sums of `values` over the nodes of each unitig; a
    node with no unitig adds into a dropped slot (no host sync)."""
    slot = torch.where(uid >= 0, uid, num_u)
    s = torch.zeros(num_u + 1, dtype=torch.int64, device=uid.device)
    return s.index_add_(0, slot, values.to(torch.int64))[:num_u]


def unitig_count_sums_plain(uid: torch.Tensor, counts: torch.Tensor,
                            num_u: int) -> torch.Tensor:
    """Plain version of unitig_count_sums on CPU tensors: numpy's unbuffered
    float32 add.at, one node at a time in id order, as XLA's CPU backend
    runs the reference's scatter-add."""
    slot = torch.where(uid >= 0, uid, num_u).numpy()
    s = np.zeros(num_u + 1, np.float32)
    np.add.at(s, slot, counts.numpy().astype(np.float32))
    return torch.from_numpy(s[:num_u])


def unitig_count_sums(uid: torch.Tensor, counts: torch.Tensor,
                      num_u: int, with_ulen: bool = False):
    """dbg.py:338-340 and clean.py:512-514: per-unitig float32 sums of node
    counts, each the sequential float32 sum in node-id order that the
    reference's scatter-add gives (above 2^24 it differs from the exact
    sum); with `with_ulen`, (sums, ulen), ulen (dbg.py:336-337) the int64
    node count of each unitig, from the same read. A CUDA tensor launches
    csrc/unitig_sum.cu (K7) once, with no host sync; a CPU tensor takes
    the plain version (and _per_unitig_sum for ulen)."""
    counts = counts.to(torch.int64)
    if uid.device != counts.device:
        raise ValueError("uid and counts must share one device")
    if uid.device.type == "cpu":
        csum = unitig_count_sums_plain(uid, counts, num_u)
        if not with_ulen:
            return csum
        return csum, _per_unitig_sum(uid, torch.ones_like(uid), num_u)
    if uid.device.type != "cuda":
        raise ValueError(f"unsupported device {uid.device}")
    out = torch.empty(num_u, dtype=torch.float32, device=uid.device)
    ulen = (torch.empty(num_u, dtype=torch.int64, device=uid.device)
            if with_ulen else None)
    kernels.unitig_sum(uid.contiguous(), counts.contiguous(), num_u, out,
                       ulen)
    return (out, ulen) if with_ulen else out


def _rank_pass(nxt: torch.Tensor, iters: int):
    """prv (the chain predecessor of each oriented id, by twin symmetry:
    prv[j] = nxt[j ^ 1] ^ 1) and its pointer-doubling ranks: (prv, rank,
    head, ptr_rem, stats) as ops/rank.py:rank_from_prev gives them."""
    arange = torch.arange(nxt.shape[0], device=nxt.device)
    nt = nxt[arange ^ 1]
    prv = torch.where(nt >= 0, nt ^ 1, INVALID)
    ptr_rem, rank, head, stats = rank_from_prev(prv, iters)
    return prv, rank, head, ptr_rem, stats


def _rank_chains(nxt: torch.Tensor, iters: int):
    """dbg.py:240-298: ranks of the chain links nxt (oriented id 2i+o ->
    the next one, or -1), with every junction-free cycle cut once. Returns
    (prv, rank, head) after the cut and whether the cut ran. On the card
    the only host sync is the read of the first pass's live flag."""
    prv, rank, head, ptr_rem, stats = _rank_pass(nxt, iters)
    cut = bool(stats[1])
    if cut:
        # mirror-consistent cycle cut (dbg.py:263-293): edge j -> nxt[j] and
        # its strand mirror share the id pair {j, nxt[j]^1}; cutting the
        # smallest pair of each cycle picks the same physical cut on both
        # strands
        m = nxt.shape[0]
        arange = torch.arange(m, device=nxt.device)
        in_cycle = ptr_rem >= 0
        ea = torch.where(nxt >= 0, torch.minimum(arange, nxt ^ 1), m)
        eb = torch.where(nxt >= 0, torch.maximum(arange, nxt ^ 1), m)
        a, bb = cycle_min_pair(torch.where(in_cycle, prv, INVALID), ea, eb,
                               iters)
        cut_here = in_cycle & (ea == a) & (eb == bb)
        nxt = torch.where(cut_here, INVALID, nxt)
        prv, rank, head, _ptr, _stats = _rank_pass(nxt, iters)
    return prv, rank, head, cut


def _label_core(succ_idx, succ_orient, outdeg, is_junction, alive, counts,
                iters: int) -> Labels:
    n = alive.shape[0]
    dev = alive.device
    m = 2 * n
    nidx = torch.arange(n, device=dev)
    nxt_o = []
    for o in (0, 1):
        uniq = outdeg[o] == 1
        row = succ_idx[o]                               # (4, n)
        bsel = torch.argmax((row >= 0).to(torch.int8), dim=0)
        s = row[bsel, nidx]
        p = succ_orient[o][bsel, nidx]
        s_ok = (s >= 0) & ~is_junction[s.clamp(0, n - 1)]
        src_ok = alive & ~is_junction & uniq
        nxt_o.append(torch.where(src_ok & s_ok, 2 * s + p, INVALID))
    nxt = torch.stack(nxt_o, dim=1).reshape(-1)        # oriented id 2i+o

    prv, rank, head, _cut = _rank_chains(nxt, iters)
    arange = torch.arange(m, device=dev)
    twin = arange ^ 1
    # chain tail via twin symmetry: tail = head[twin] ^ 1
    tail = head[twin] ^ 1

    node_alive_nonj = alive & ~is_junction
    oriented_valid = node_alive_nonj[:, None].expand(n, 2).reshape(-1)
    is_head = oriented_valid & (prv == INVALID)
    rep = is_head & (arange <= (tail ^ 1))

    rep_i = torch.cumsum(rep.to(torch.int64), dim=0) - 1
    num_u = int(rep.sum())
    head_uid = torch.where(rep, rep_i, INVALID)

    uid_o = head_uid[head]
    uid_t = head_uid[tail ^ 1]
    use_twin = (uid_o < 0) & (uid_t >= 0)
    uid_j = torch.where(use_twin, uid_t, uid_o)
    chain_len = rank[tail] + 1
    pos_j = torch.where(use_twin, chain_len - 1 - rank, rank)
    orient_j = torch.where(use_twin, (arange ^ 1) & 1, arange & 1)

    uid_e, uid_d = uid_j[0::2], uid_j[1::2]
    use_e = uid_e >= 0
    uid = torch.where(use_e, uid_e, uid_d)
    upos = torch.where(use_e, pos_j[0::2], pos_j[1::2])
    uorient = torch.where(use_e, orient_j[0::2], orient_j[1::2])
    uid = torch.where(node_alive_nonj, uid, INVALID)

    # after num_u, nothing reads the card: masks become dropped slots
    csum, ulen = unitig_count_sums(uid, counts, num_u, True)
    ucov = torch.floor(csum / torch.clamp(ulen, min=1).to(torch.float32)
                       + 0.5).to(torch.int64)
    heads_idx = torch.empty(num_u + 1, dtype=torch.int64, device=dev)
    heads_idx = heads_idx.scatter_(0, torch.where(rep, rep_i, num_u),
                                   arange)[:num_u]
    utail = tail[heads_idx]
    return Labels(uid, upos, uorient, num_u, ulen, ucov, heads_idx, utail)


@dataclass
class Unitigs:
    """Host copies of the labeling's per-unitig fields, with the JAX
    package's host dtypes (dbg.py:370). The per-node fields stay on the
    device (DBG.label_unitigs_device, DBG.topo)."""

    ulen: np.ndarray
    ucov: np.ndarray
    uhead: np.ndarray
    utail: np.ndarray
    num_unitigs: int


def unitig_to_nodes(lab: Labels, per_unitig: torch.Tensor) -> torch.Tensor:
    """(n,) per node: its unitig's entry of per_unitig (U,), or zero (False
    for a mask) for a node of no unitig, read from a spare slot (no host
    sync)."""
    spare = torch.cat([per_unitig, per_unitig.new_zeros(1)])
    return spare[torch.where(lab.uid >= 0, lab.uid, lab.num_u)]


class DBG:
    """Graph state: sorted canonical k-mer table + alive mask (dbg.py:469).

    keys (n, L) int64 lanes, counts (n,) int64, both on the graph's device.
    Mutation flips `alive` bits; topology updates by masking and the
    labeling recomputes lazily."""

    def __init__(self, k: int, keys: torch.Tensor, counts: torch.Tensor,
                 n: int | None = None):
        self.k = k
        self.n = int(keys.shape[0] if n is None else n)
        self.keys = keys[: self.n].contiguous()
        self.counts = counts[: self.n].to(torch.int64)
        self.alive = torch.ones(self.n, dtype=torch.bool, device=keys.device)
        self._topo = None
        self._labels = None
        self._unitigs = None

    @property
    def device(self) -> torch.device:
        return self.keys.device

    def invalidate(self) -> None:
        self._topo = None
        self._labels = None
        self._unitigs = None

    @property
    def topo(self):
        """(succ_idx (2,4,n), succ_orient (2,4,n), out (2,n), outdeg (2,n),
        is_junction (n,))."""
        if self._topo is None:
            self._topo = _adjacency(self.keys, self.alive, self.k)
        return self._topo

    def label_unitigs_device(self) -> Labels:
        if self._labels is None:
            succ_idx, succ_orient, _out, outdeg, is_junction = self.topo
            cap = _next_pow2(self.n)
            iters = max(1, math.ceil(math.log2(max(cap, 2))) + 1)
            self._labels = _label_core(succ_idx, succ_orient, outdeg,
                                       is_junction, self.alive, self.counts,
                                       iters)
        return self._labels

    def label_unitigs(self) -> Unitigs:
        """Host copy of the per-unitig fields: one read of the card."""
        if self._unitigs is None:
            lab = self.label_unitigs_device()
            ulen, ucov, uhead, utail = torch.stack(
                [lab.ulen, lab.ucov, lab.uhead, lab.utail]).cpu().numpy()
            self._unitigs = Unitigs(
                ulen=ulen.astype(np.int32), ucov=ucov.astype(np.uint32),
                uhead=uhead.astype(np.int32), utail=utail.astype(np.int32),
                num_unitigs=lab.num_u)
        return self._unitigs

    # -- sequences ---------------------------------------------------------
    def unitig_sequences_flat_device(self):
        """dbg.py:432 _sequence_flat_kernel: all unitig sequences in one
        flat uint8 tensor; unitig u is flat[offs[u]: offs[u] + lens[u]],
        lens = ulen + k - 1. Every node writes its last base (in traversal
        orientation) and each unitig's head writes its first k-1 bases;
        these positions are disjoint, so no scatter has duplicate indices.
        Returns (flat, offs (U,) int64, lens (U,) int64) on the device."""
        lab = self.label_unitigs_device()
        k = self.k
        dev = self.device
        U = lab.num_u
        lens = lab.ulen + (k - 1)
        offs = torch.cumsum(lens, dim=0) - lens
        if U == 0:
            return (torch.zeros(0, dtype=torch.uint8, device=dev), offs,
                    lens)
        total = int(lens.sum())
        W = num_words(k)
        words = lanes_to_words(self.keys, W)
        owords = torch.where((lab.uorient == 0)[:, None], words,
                             revcomp_words(words, k))
        member = lab.uid >= 0
        uid_c = lab.uid.clamp(min=0)
        # every node writes; a node of no unitig writes to a spare last slot
        flat = torch.full((total + 1,), 4, dtype=torch.uint8, device=dev)
        flat[torch.where(member, offs[uid_c] + lab.upos + (k - 1), total)] = \
            (owords[:, W - 1] & 3).to(torch.uint8)
        hn = torch.zeros(U + 1, dtype=torch.int64, device=dev)
        hn = hn.scatter_(0, torch.where(member & (lab.upos == 0), uid_c, U),
                         torch.arange(self.n, device=dev))[:U]
        head_codes = kmer_to_codes(words_to_lanes(owords[hn]), k)[:, : k - 1]
        hpos = offs[:, None] + torch.arange(k - 1, device=dev)[None, :]
        flat[hpos.reshape(-1)] = head_codes.reshape(-1)
        return flat[:total], offs, lens

    def unitig_sequences_flat(self):
        """Host form of unitig_sequences_flat_device (numpy): one pull of
        the flat bases; offs and lens come from the host labeling."""
        lens = self.label_unitigs().ulen.astype(np.int64) + (self.k - 1)
        flat = self.unitig_sequences_flat_device()[0].cpu().numpy()
        return flat, np.cumsum(lens) - lens, lens

    def junction_info(self):
        """(indices, counts) of alive junction k-mers (host)."""
        isj = self.topo[4]
        idx = torch.nonzero(isj)[:, 0]
        return (idx.cpu().numpy(),
                self.counts[idx].cpu().numpy().astype(np.uint32))

    # -- mutation ----------------------------------------------------------
    def delete_nodes(self, node_mask) -> None:
        """Kill nodes; an existing topology updates by masking."""
        mask = torch.as_tensor(node_mask, device=self.device)
        self.alive = self.alive & ~mask
        if self._topo is not None:
            si, so, _out, _od, _isj = self._topo
            self._topo = _mask_topo_core(si, so, self.alive)
            self._labels = None
            self._unitigs = None
        else:
            self.invalidate()

    def delete_unitigs(self, unitig_mask) -> None:
        mask = torch.as_tensor(unitig_mask, device=self.device)
        self.delete_nodes(unitig_to_nodes(self.label_unitigs_device(), mask))
