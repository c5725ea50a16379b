"""Short-read seed-and-extend mapper over contigs (counterpart of
platanus_b_tpu/models/mapper.py).

- ``ContigIndex``: every forward keyLength-mer of the contigs as a sorted
  key table with position payloads, at the JAX package's capacities and
  pad values (pool padded with code 4 to a power of two of at least 64,
  key table padded with SENTINEL rows, ``key_pos`` with 0), so the clips
  of the candidate search read the same cells as the reference.
- ``map_reads``: seeds from the read tail, fwd + rev key lookup, exact
  extension, unique-extension filter, modal vote (mapper.cpp:321-410).
- ``map_reads_multi``: every extended candidate position of the same
  search, deduplicated (mapper.cpp:415-536), for tagged libraries.
- ``map_reads_ungap``: the same candidates scored by a full-overlap
  ungapped alignment (mapper.cpp:537-682), for polish. The scoring runs in
  the hand-written CUDA kernel ``ungap_align`` (csrc/ungap_align.cu) on
  the card; ``ungap_align_plain`` below is its plain PyTorch version.

The forward k-mers of reads and contigs come from the ``kmer_extract``
kernel. Candidate tensors are (R, S, H): S seeds per read, H candidate
postings per seed. Reads are processed READ_CHUNK at a time.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..ops.keys import SENTINEL_LANE, num_lanes, revcomp, sort_keys
from ..ops.kmer import extract_kmers_packed, pack_codes
from ..ops.search import lookup_range
from .dbg import _next_pow2

MAX_CANDIDATES = 16  # H: static per-seed candidate budget

# ungapped alignment scores (mapper.cpp:29-31)
MATCH_SCORE = 1
MISMATCH_SCORE = -50

INT32_MIN = -(1 << 31)
READ_CHUNK = 1 << 18          # reads per candidate pass
UNGAP_PLAIN_CHUNK = 8192      # reads per step of the plain ungapped scoring


def _forward_kmers(codes: torch.Tensor, k: int, max_len: int):
    """Forward k-mers of every window of (R, Lc) codes through kmer_extract
    and whether each window is free of N/padding: (keys (R, P, L), valid
    (R, P)), P = max_len - k + 1 (ops/kmer.py:extract_forward_kmers)."""
    R, Lc = codes.shape
    width = max(-(-Lc // 32) * 32, 32)
    if width != Lc:
        padded = torch.full((R, width), 4, dtype=torch.uint8,
                            device=codes.device)
        padded[:, :Lc] = codes
        codes = padded
    words, nmask = pack_codes(codes)
    keys, _n = extract_kmers_packed(words, k, nmask=nmask, max_len=max_len,
                                    forward_only=True)
    P = keys.shape[1]
    is_n = (codes[:, :max_len] > 3).to(torch.int32)
    csum = torch.nn.functional.pad(torch.cumsum(is_n, dim=1), (1, 0))
    valid = (csum[:, k:k + P] - csum[:, :P]) == 0
    return keys, valid


class ContigIndex:
    """Concatenated contig pool + sorted forward k-mer position table."""

    def __init__(self, contigs: list[np.ndarray], key_length: int = 32,
                 device="cpu"):
        lengths = np.array([len(c) for c in contigs], dtype=np.int32)
        starts = np.zeros(len(contigs) + 1, dtype=np.int32)
        np.cumsum(lengths, out=starts[1:])
        pool = (np.concatenate(contigs) if contigs
                else np.zeros((0,), np.uint8)).astype(np.uint8)
        padded = np.full((_next_pow2(max(len(pool), 1), minimum=64),), 4,
                         dtype=np.uint8)
        padded[: len(pool)] = pool
        self._set_contigs(key_length, padded, starts, lengths, device)
        self._build_key_table(len(pool))

    def _set_contigs(self, key_length, pool, starts, lengths, device):
        self.key_length = int(key_length)
        self.num_contigs = len(lengths)
        self.device = torch.device(device)
        self.pool = np.asarray(pool, np.uint8)
        self.starts = np.asarray(starts, np.int32)
        self.lengths = np.asarray(lengths, np.int32)
        self.pool_t = torch.from_numpy(self.pool).to(self.device)
        self.starts_t = torch.from_numpy(self.starts).to(self.device)
        self.starts64 = self.starts_t.to(torch.int64)
        self.lengths_t = torch.from_numpy(self.lengths).to(self.device)

    @classmethod
    def from_arrays(cls, key_length: int, key_table: torch.Tensor,
                    key_pos, pool, starts, lengths, table_len: int,
                    device="cpu") -> "ContigIndex":
        """An index from its arrays: key_table (cap, L) int64 lanes, key_pos
        (cap,), padded pool, starts (C+1,), lengths (C,) (numpy)."""
        index = cls.__new__(cls)
        index._set_contigs(key_length, pool, starts, lengths, device)
        index.table_len = int(table_len)
        index.key_table = key_table.to(index.device)
        index.key_pos = torch.as_tensor(np.asarray(key_pos, np.int64)).to(
            index.device)
        return index

    def _build_key_table(self, n_bases: int) -> None:
        """Windows of the whole pool in one kmer_extract pass; a window is
        kept when it is N-free and ends inside its contig. Equal keys keep
        pool order, as the reference's stable lexsort does."""
        k = self.key_length
        dev = self.device
        lanes = num_lanes(k)
        keys = torch.zeros((0, lanes), dtype=torch.int64, device=dev)
        pos = torch.zeros((0,), dtype=torch.int64, device=dev)
        if n_bases >= k:
            fk, valid = _forward_kmers(self.pool_t[None, :n_bases], k,
                                       n_bases)
            p = torch.arange(fk.shape[1], device=dev)
            cid = torch.searchsorted(self.starts64, p, right=True) - 1
            ends = self.starts64[cid + 1]
            sel = valid[0] & (p + k <= ends)
            keys, pos = sort_keys(fk[0][sel], p[sel])
        self.table_len = int(keys.shape[0])
        cap = _next_pow2(max(self.table_len, 1), minimum=64)
        self.key_table = torch.full((cap, lanes), SENTINEL_LANE,
                                    dtype=torch.int64, device=dev)
        self.key_table[: self.table_len] = keys
        self.key_pos = torch.zeros((cap,), dtype=torch.int64, device=dev)
        self.key_pos[: self.table_len] = pos


# ---------------------------------------------------------------------------
# candidate search (mapper.py:128-179, :335-372)
# ---------------------------------------------------------------------------

def _candidates(index: ContigIndex, codes: torch.Tensor,
                lengths: torch.Tensor, word_len: int, S: int, H: int):
    """Seed k-mers, postings and exact extension of every (read, seed,
    candidate). Returns a dict of (R, S, H) tensors (ok, is_fwd, cid,
    offset, clen) and (R, S) tensors (i_s, seed_ok), or None when no
    window fits (L < key_len)."""
    key_len = index.key_length
    R, L = codes.shape
    P = max(L - key_len + 1, 1)
    C = index.num_contigs
    fkeys, fvalid = _forward_kmers(codes, key_len, L)
    if fkeys.shape[1] == 0:
        return None
    dev = codes.device
    lengths = lengths.to(torch.int64)
    s_idx = torch.arange(S, device=dev)
    i_raw = lengths[:, None] - word_len - s_idx[None, :] * word_len
    seed_exists = (i_raw > -word_len) & (lengths[:, None] >= word_len)
    i_s = i_raw.clamp(0, P - 1)
    rows = torch.arange(R, device=dev)[:, None]
    fk = fkeys[rows, i_s]                              # (R, S, lanes)
    kvalid = fvalid[rows, i_s] & seed_exists
    rk = revcomp(fk, key_len)
    nl = fk.shape[-1]
    q = torch.cat([fk.reshape(-1, nl), rk.reshape(-1, nl)])
    lo, hi = lookup_range(index.key_table, q, index.table_len)
    n_f = (hi[: R * S] - lo[: R * S]).reshape(R, S)
    n_r = (hi[R * S:] - lo[R * S:]).reshape(R, S)
    lo_f = lo[: R * S].reshape(R, S)
    lo_r = lo[R * S:].reshape(R, S)
    tot = n_f + n_r
    seed_ok = kvalid & (tot > 0) & (tot <= H)

    j = torch.arange(H, device=dev)[None, None, :]
    is_fwd = j < n_f[..., None]
    pidx = torch.where(is_fwd, lo_f[..., None] + j,
                       lo_r[..., None] + (j - n_f[..., None]))
    cand = (j < tot[..., None]) & seed_ok[..., None]
    pidx = pidx.clamp(0, index.key_pos.shape[0] - 1)
    gpos = index.key_pos[pidx]
    cid = (torch.searchsorted(index.starts64, gpos, right=True)
           - 1).clamp(0, C - 1)
    offset = gpos - index.starts64[cid]
    clen = index.lengths_t.to(torch.int64)[cid]

    ok = cand & torch.where(is_fwd, offset <= clen - word_len,
                            offset >= word_len - key_len)
    pool = index.pool_t
    pool_n = pool.shape[0]
    for kk in range(key_len, word_len):
        rb = codes[rows[..., None], (i_s[..., None] + kk).clamp(0, L - 1)]
        fpos = (gpos + kk).clamp(0, pool_n - 1)
        rpos = (gpos + key_len - 1 - kk).clamp(0, pool_n - 1)
        ok = ok & torch.where(is_fwd, pool[fpos] == rb, pool[rpos] == (3 ^ rb))
    return {"ok": ok, "is_fwd": is_fwd, "cid": cid, "offset": offset,
            "clen": clen, "i_s": i_s, "seed_ok": seed_ok}


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(a, -1, idx[..., None])[..., 0]


def _map_votes(index: ContigIndex, codes, lengths, word_len: int, S: int,
               H: int):
    """Per-seed uniquely extended positions (vote_id/vote_off, 0 = none)
    and seed_valid (mapper.py:119-194)."""
    R = codes.shape[0]
    c = _candidates(index, codes, lengths, word_len, S, H)
    if c is None:
        z = torch.zeros((R, S), dtype=torch.int64, device=codes.device)
        return z, z, z.bool()
    ok, is_fwd, i_s = c["ok"], c["is_fwd"], c["i_s"]
    n_success = ok.sum(dim=-1)
    seed_valid = c["seed_ok"] & (n_success == 1)
    pick = torch.argmax(ok.to(torch.int32), dim=-1)
    v_isfwd = _take(is_fwd, pick)
    v_cid = _take(c["cid"], pick)
    v_off = _take(c["offset"], pick)
    vote_id = torch.where(v_isfwd, v_cid + 1, -(v_cid + 1))
    vote_off = torch.where(v_isfwd, v_off - i_s,
                           v_off + i_s + index.key_length - 1)
    vote_id = torch.where(seed_valid, vote_id, 0)
    return vote_id, vote_off, seed_valid


def _map_chunk(index: ContigIndex, codes, lengths, word_len: int, S: int,
               H: int):
    """_map_kernel (mapper.py:197-222): modal (id, offset) vote with the
    unique-top-group rule (mapper.cpp:383-409)."""
    vote_id, vote_off, seed_valid = _map_votes(index, codes, lengths,
                                               word_len, S, H)
    eq = ((vote_id[:, :, None] == vote_id[:, None, :])
          & (vote_off[:, :, None] == vote_off[:, None, :])
          & seed_valid[:, None, :])
    cnt = eq.sum(dim=-1) * seed_valid
    m1 = cnt.max(dim=-1).values
    n_top = ((cnt == m1[:, None]) & seed_valid).sum(dim=-1)
    mapped = (m1 > 0) & (n_top == m1)
    best = torch.argmax(cnt, dim=-1)
    bid = _take(vote_id, best)
    boff = _take(vote_off, best)
    return torch.where(mapped, bid, 0), torch.where(mapped, boff, 0)


def _as_device(codes, lengths, device):
    codes = torch.as_tensor(np.ascontiguousarray(codes)
                            if isinstance(codes, np.ndarray) else codes)
    lengths = torch.as_tensor(np.ascontiguousarray(lengths)
                              if isinstance(lengths, np.ndarray) else lengths)
    return (codes.to(device=device, dtype=torch.uint8),
            lengths.to(device=device, dtype=torch.int32))


def map_reads(index: ContigIndex, codes, lengths,
              seed_lengths: list[int] | tuple[int, ...] = (32,),
              max_candidates: int = MAX_CANDIDATES):
    """mapReadMultiSeedFiltered over a batch (mapper.cpp:506-516): try each
    seed length in order, fall through for still-unmapped reads. Returns
    numpy (ids, offsets) int32."""
    codes, lengths = _as_device(codes, lengths, index.device)
    R, L = codes.shape
    ids = np.zeros((R,), np.int32)
    offs = np.zeros((R,), np.int32)
    todo = np.ones((R,), bool)
    for word_len in seed_lengths:
        word_len = int(word_len)
        if not todo.any() or L < word_len:
            break
        S = max(-(-L // word_len) + 1, 1)
        i_parts, o_parts = [], []
        for r0 in range(0, R, READ_CHUNK):
            i, o = _map_chunk(index, codes[r0: r0 + READ_CHUNK],
                              lengths[r0: r0 + READ_CHUNK], word_len, S,
                              max_candidates)
            i_parts.append(i)
            o_parts.append(o)
        i = torch.cat(i_parts).cpu().numpy().astype(np.int32)
        o = torch.cat(o_parts).cpu().numpy().astype(np.int32)
        take = todo & (i != 0)
        ids[take], offs[take] = i[take], o[take]
        todo &= ~take
    return ids, offs


def _map_chunk_multi(index: ContigIndex, codes, lengths, word_len: int,
                     S: int, H: int):
    """_map_kernel_multi (mapper.py:225-243): every extended candidate
    position, no unique-extension or vote filter; (R, S*H) int32 ids and
    offsets, 0 = empty slot."""
    R = codes.shape[0]
    c = _candidates(index, codes, lengths, word_len, S, H)
    if c is None:
        z = torch.zeros((R, S * H), dtype=torch.int32, device=codes.device)
        return z, z
    ok, is_fwd, cid, i_s = c["ok"], c["is_fwd"], c["cid"], c["i_s"][..., None]
    rep_id = torch.where(ok, torch.where(is_fwd, cid + 1, -(cid + 1)), 0)
    rep_off = torch.where(is_fwd, c["offset"] - i_s,
                          c["offset"] + i_s + index.key_length - 1)
    rep_off = torch.where(ok, rep_off, 0)
    return (rep_id.reshape(R, -1).to(torch.int32),
            rep_off.reshape(R, -1).to(torch.int32))


def map_reads_multi(index: ContigIndex, codes, lengths,
                    seed_lengths: list[int] | tuple[int, ...] = (32,),
                    max_candidates: int = MAX_CANDIDATES):
    """All distinct mapped positions per read (multi-report,
    mapReadMultiReportsMultiSeedFiltered, mapper.cpp:506-536).

    Returns (read_idx, ids, offs) flat numpy arrays, one row per distinct
    (read, signed contig id, offset) report in the reference's order;
    seed lengths fall through for reads with zero reports."""
    codes, lengths = _as_device(codes, lengths, index.device)
    R, L = codes.shape
    rows_out = []
    todo = np.ones((R,), bool)
    for word_len in seed_lengths:
        word_len = int(word_len)
        if not todo.any() or L < word_len:
            break
        S = max(-(-L // word_len) + 1, 1)
        parts = [_map_chunk_multi(index, codes[r0: r0 + READ_CHUNK],
                                  lengths[r0: r0 + READ_CHUNK], word_len, S,
                                  max_candidates)
                 for r0 in range(0, R, READ_CHUNK)]
        vid = torch.cat([p[0] for p in parts]).cpu().numpy()
        voff = torch.cat([p[1] for p in parts]).cpu().numpy()
        ridx = np.repeat(np.arange(R), vid.shape[1])
        flat_id = vid.reshape(-1)
        flat_off = voff.reshape(-1)
        keep = (flat_id != 0) & todo[ridx]
        if keep.any():
            rec = np.stack([ridx[keep], flat_id[keep], flat_off[keep]],
                           axis=1)
            rec = np.unique(rec, axis=0)
            rows_out.append(rec)
            todo[np.unique(rec[:, 0])] = False
    if not rows_out:
        z = np.zeros(0, np.int64)
        return z, z.astype(np.int32), z.astype(np.int32)
    rec = np.concatenate(rows_out, axis=0)
    order = np.lexsort((rec[:, 2], rec[:, 1], rec[:, 0]))
    rec = rec[order]
    return (rec[:, 0].astype(np.int64), rec[:, 1].astype(np.int32),
            rec[:, 2].astype(np.int32))


# ---------------------------------------------------------------------------
# ungapped-alignment scoring (mapper.py:374-443): kernel and plain version
# ---------------------------------------------------------------------------

def _ungap_plain_chunk(codes, lengths, pool, starts, ok, is_fwd, cid, ro,
                       clen, min_identity: float):
    R, L = codes.shape
    _R, S, H = ok.shape
    dev = codes.device
    pool_n = pool.shape[0]
    a_start = torch.where(is_fwd, (-ro).clamp(min=0),
                          (ro - (clen - 1)).clamp(min=0))
    Lr = lengths[:, None, None]
    a_end = torch.where(is_fwd, torch.minimum(Lr, clen - ro),
                        torch.minimum(Lr, ro + 1))
    span = (a_end - a_start).clamp(min=0)

    p = torch.arange(L, dtype=torch.int32, device=dev)
    coord = torch.where(is_fwd[..., None], ro[..., None] + p,
                        ro[..., None] - p)                  # (R, S, H, L)
    gcoord = (starts[cid][..., None] + coord).clamp(0, pool_n - 1)
    cb = pool.index_select(0, gcoord.reshape(-1)).reshape(gcoord.shape)
    del coord, gcoord
    tb = torch.where(is_fwd[..., None], cb, 3 ^ cb.clamp(max=3))
    rb = codes[:, None, None, :]
    in_span = (p >= a_start[..., None]) & (p < a_end[..., None])
    mm = in_span & (rb != 4) & (cb != 4) & (tb != rb)
    mis = mm.sum(dim=-1, dtype=torch.int32)
    del cb, tb, in_span, mm

    one_minus = (torch.tensor(1.0, dtype=torch.float32)
                 - torch.tensor(min_identity, dtype=torch.float32)).to(dev)
    mis_thresh = (one_minus * span.to(torch.float32)).to(torch.int32)
    good = ok & (mis <= mis_thresh) & (span > 0)
    score = MATCH_SCORE * (span - mis) + MISMATCH_SCORE * mis
    score = torch.where(good, score, INT32_MIN)

    SH = S * H
    f_cid = cid.reshape(R, SH)
    f_ro = ro.reshape(R, SH)
    f_fwd = is_fwd.reshape(R, SH)
    flat = score.reshape(R, SH)
    eqm = ((f_cid[:, :, None] == f_cid[:, None, :])
           & (f_ro[:, :, None] == f_ro[:, None, :])
           & (f_fwd[:, :, None] == f_fwd[:, None, :]))
    idx = torch.arange(SH, device=dev)
    earlier = eqm & (idx[None, None, :] < idx[None, :, None])
    has_earlier = (earlier & (flat[:, None, :] > INT32_MIN)).any(dim=-1)
    flat = torch.where(~has_earlier, flat, INT32_MIN)

    best = torch.argmax(flat, dim=-1)
    max_score = _take(flat, best)
    n_best = ((flat == max_score[:, None]) & (flat > INT32_MIN)).sum(dim=-1)
    unique = (max_score > INT32_MIN) & (n_best == 1)

    def pick(a):
        return _take(a.reshape(R, SH), best)

    b_fwd, b_cid, b_ro = pick(is_fwd), pick(cid), pick(ro)
    b_mis, b_span = pick(mis), pick(span)
    out_id = torch.where(unique, torch.where(b_fwd, b_cid + 1, -(b_cid + 1)),
                         0).to(torch.int32)
    ident = torch.where(b_span > 0,
                        (b_span - b_mis).to(torch.float32)
                        / b_span.clamp(min=1).to(torch.float32),
                        torch.zeros((), dtype=torch.float32, device=dev))
    return (out_id, b_ro.to(torch.int32), ident, b_mis.to(torch.int32),
            b_span.to(torch.int32))


def ungap_align_plain(codes, lengths, pool, starts, ok, is_fwd, cid, ro,
                      clen, min_identity: float,
                      chunk: int = UNGAP_PLAIN_CHUNK):
    """Plain PyTorch version of the ungap_align kernel: the transcription
    of mapper.py:374-443, `chunk` reads per step so that no intermediate
    exceeds about 1 GB. Returns (id, ro, identity, mis, span), each (R,)."""
    R = codes.shape[0]
    parts = [_ungap_plain_chunk(codes[r0: r0 + chunk],
                                lengths[r0: r0 + chunk], pool, starts,
                                ok[r0: r0 + chunk], is_fwd[r0: r0 + chunk],
                                cid[r0: r0 + chunk], ro[r0: r0 + chunk],
                                clen[r0: r0 + chunk], min_identity)
             for r0 in range(0, R, max(int(chunk), 1))]
    if not parts:
        z = torch.zeros(0, dtype=torch.int32, device=codes.device)
        return z, z, z.to(torch.float32), z, z
    return tuple(torch.cat(x) for x in zip(*parts))


def ungap_align(codes: torch.Tensor, lengths: torch.Tensor,
                pool: torch.Tensor, starts: torch.Tensor, ok: torch.Tensor,
                is_fwd: torch.Tensor, cid: torch.Tensor, ro: torch.Tensor,
                clen: torch.Tensor, min_identity: float):
    """Ungapped full-overlap scoring of (R, S, H) seed candidates: the
    wrapper of the ungap_align CUDA kernel (csrc/ungap_align.cu).

    codes (R, L) uint8; lengths (R,) int32; pool (cap,) uint8; starts
    (C+1,) int32; ok, is_fwd (R, S, H) bool; cid, ro, clen (R, S, H)
    int32; all contiguous on one device. Returns (id, ro, identity, mis,
    span), each (R,): int32, int32, float32, int32, int32. CPU tensors run
    the plain version; CUDA tensors launch the kernel or raise."""
    if codes.dim() != 2 or codes.dtype != torch.uint8:
        raise ValueError("codes must be an (R, L) uint8 tensor")
    R, L = codes.shape
    if ok.dim() != 3 or ok.shape[0] != R:
        raise ValueError("ok must be an (R, S, H) tensor")
    shape = tuple(ok.shape)
    checks = [("lengths", lengths, torch.int32, (R,)),
              ("pool", pool, torch.uint8, None),
              ("starts", starts, torch.int32, None),
              ("ok", ok, torch.bool, shape),
              ("is_fwd", is_fwd, torch.bool, shape),
              ("cid", cid, torch.int32, shape),
              ("ro", ro, torch.int32, shape),
              ("clen", clen, torch.int32, shape)]
    for name, t, dtype, want in [("codes", codes, torch.uint8, None)] + checks:
        if t.dtype != dtype or not t.is_contiguous() or t.device != codes.device:
            raise ValueError(f"{name} must be a contiguous {dtype} tensor on "
                             f"{codes.device}")
        if want is not None and tuple(t.shape) != want:
            raise ValueError(f"{name} must have shape {want}")
    if pool.dim() != 1 or pool.shape[0] == 0 or starts.dim() != 1:
        raise ValueError("pool and starts must be non-empty 1-D tensors")
    if codes.device.type == "cpu":
        return ungap_align_plain(codes, lengths, pool, starts, ok, is_fwd,
                                 cid, ro, clen, min_identity)
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")
    dev = codes.device
    out = (torch.empty(R, dtype=torch.int32, device=dev),
           torch.empty(R, dtype=torch.int32, device=dev),
           torch.empty(R, dtype=torch.float32, device=dev),
           torch.empty(R, dtype=torch.int32, device=dev),
           torch.empty(R, dtype=torch.int32, device=dev))
    if R and L:
        kernels.ungap_align(codes, lengths, pool, starts, ok, is_fwd, cid, ro,
                            clen, min_identity, out)
    return out


def ungap_candidates(index: ContigIndex, codes: torch.Tensor,
                     lengths: torch.Tensor, seed_len: int, S: int, H: int):
    """The candidate half of _map_ungap_kernel (mapper.py:335-377) as the
    ungap_align inputs: (ok, is_fwd, cid, ro, clen), contiguous, int32."""
    c = _candidates(index, codes, lengths, seed_len, S, H)
    is_fwd, i_s = c["is_fwd"], c["i_s"][..., None]
    ro = torch.where(is_fwd, c["offset"] - i_s,
                     c["offset"] + i_s + index.key_length - 1)
    return (c["ok"].contiguous(), is_fwd.contiguous(),
            c["cid"].to(torch.int32).contiguous(),
            ro.to(torch.int32).contiguous(),
            c["clen"].to(torch.int32).contiguous())


def map_reads_ungap_full(index: ContigIndex, codes, lengths,
                         min_identity: float, seed_length: int = 32,
                         max_candidates: int = MAX_CANDIDATES):
    """All five outputs of _map_ungap_kernel per read, as tensors on the
    index's device: (id, ro, identity, mis, span)."""
    codes, lengths = _as_device(codes, lengths, index.device)
    R, L = codes.shape
    S = max(-(-L // seed_length) + 1, 1)
    parts = []
    for r0 in range(0, R, READ_CHUNK):
        c = codes[r0: r0 + READ_CHUNK]
        ln = lengths[r0: r0 + READ_CHUNK]
        cand = ungap_candidates(index, c, ln, int(seed_length), S,
                                max_candidates)
        parts.append(ungap_align(c, ln, index.pool_t, index.starts_t, *cand,
                                 min_identity))
    return tuple(torch.cat(x) for x in zip(*parts))


def map_reads_ungap(index: ContigIndex, codes, lengths, min_identity: float,
                    seed_length: int = 32,
                    max_candidates: int = MAX_CANDIDATES):
    """Batch mapReadUngapAlignment. Returns numpy (ids, offsets,
    identities)."""
    R, L = codes.shape
    if L < seed_length or index.table_len == 0 or R == 0:
        return (np.zeros((R,), np.int32), np.zeros((R,), np.int32),
                np.zeros((R,), np.float32))
    i, o, ident, _mis, _span = map_reads_ungap_full(
        index, codes, lengths, min_identity, seed_length, max_candidates)
    return i.cpu().numpy(), o.cpu().numpy(), ident.cpu().numpy()
