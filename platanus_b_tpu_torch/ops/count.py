"""Deterministic k-mer counting: sort + run lengths (counterpart of ops/count.py).

One counting path: extract all canonical windows (``kmer_extract``), sort
the lanes, find run ends, take run lengths from an exclusive ``cummax`` of
end positions, and compact the run ends. Tables are trimmed to their live
rows (no power-of-two capacity): ``(keys (n, L) int64 lanes, counts (n,)
int64)``, sorted ascending. Occurrences saturate at MAX_OCCURRENCE like the
reference's u16 counter.

The host helpers at the end (cutoff, distribution average, TSV,
``kmer_occ.bin`` writer and reader) are lifted unchanged from
ops/count.py:581-780.
"""

from __future__ import annotations

import numpy as np
import torch

from .keys import is_sentinel, lexsort, num_words, sort_keys

# countKmerOrWriteTemporary saturates one below the u16 deleted-marker
# (counter.h:459-476)
MAX_OCCURRENCE = 0xFFFF - 1


def _neq_prev(skeys: torch.Tensor) -> torch.Tensor:
    return (skeys[1:] != skeys[:-1]).any(dim=1)


def _run_marks(sorted_keys: torch.Tensor):
    """(valid, is_new, is_end) over sorted keys; SENTINEL rows sort last."""
    n = sorted_keys.shape[0]
    dev = sorted_keys.device
    valid = ~is_sentinel(sorted_keys)
    neq = _neq_prev(sorted_keys)
    one = torch.ones(1, dtype=torch.bool, device=dev)
    is_new = valid & torch.cat([one, neq]) if n else valid
    is_end = valid & torch.cat([neq, one]) if n else valid
    return valid, is_new, is_end


def dedup_sum(sorted_keys: torch.Tensor, sorted_counts: torch.Tensor):
    """Collapse equal adjacent keys, summing counts (count.py:76).

    Returns (ukeys, ucounts, n_unique); SENTINEL rows are excluded. Run
    totals are differences of the inclusive cumsum at run ends."""
    valid, _is_new, is_end = _run_marks(sorted_keys)
    counts = torch.where(valid, sorted_counts.to(torch.int64), 0)
    csum = torch.cumsum(counts, dim=0)
    ends = csum[is_end]
    ucounts = torch.diff(ends, prepend=ends.new_zeros(1))
    ukeys = sorted_keys[is_end]
    return ukeys, ucounts, int(ukeys.shape[0])


def dedup_max(sorted_keys: torch.Tensor, sorted_vals: torch.Tensor):
    """Like dedup_sum but keeps the MAX value per key (count.py:105; the
    saveContig merge rule, graph.h:1760-1765). The value joins the sort as
    its last key, descending, so each run's first row holds its maximum;
    nothing relies on sort stability within a run."""
    valid = ~is_sentinel(sorted_keys)
    vals = torch.where(valid, sorted_vals.to(torch.int64), 0)
    perm = lexsort(sorted_keys, -vals)
    rkeys, rvals = sorted_keys[perm], vals[perm]
    _v, r_is_new, _e = _run_marks(rkeys)
    ukeys = rkeys[r_is_new]
    return ukeys, rvals[r_is_new], int(ukeys.shape[0])


def sort_dedup_sum(keys: torch.Tensor, counts: torch.Tensor):
    skeys, scounts = sort_keys(keys, counts)
    return dedup_sum(skeys, scounts)


def _marks_runlens(slanes: torch.Tensor, n_valid=None):
    """(is_end, counts) over sorted keys: run ends + run lengths.

    At a run's end the previous run's end position is the exclusive
    running max of end-masked positions, so length = pos - prev
    (count.py:187). With n_valid the valid rows are the sorted prefix."""
    n = slanes.shape[0]
    dev = slanes.device
    if n_valid is None:
        valid = ~is_sentinel(slanes)
    else:
        valid = torch.arange(n, device=dev) < n_valid
    neq = _neq_prev(slanes)
    is_end = valid & torch.cat([neq, torch.ones(1, dtype=torch.bool,
                                                device=dev)])
    pos = torch.arange(1, n + 1, device=dev)
    endpos = torch.where(is_end, pos, 0)
    prev = torch.cat([endpos.new_zeros(1), torch.cummax(endpos, dim=0)[0][:-1]])
    counts = torch.where(is_end, torch.clamp(pos - prev, max=MAX_OCCURRENCE), 0)
    return is_end, counts


def count_lanes_fused(keys: torch.Tensor, n_valid=None):
    """Count every window at once (count.py:274): one lexicographic sort,
    run lengths, compaction of run ends. keys (N, L), SENTINEL = invalid.
    Returns (ukeys (n, L), counts (n,) int64, n)."""
    L = keys.shape[1]
    if keys.shape[0] == 0:
        return keys, torch.zeros(0, dtype=torch.int64, device=keys.device), 0
    if L == 1:
        skeys = torch.sort(keys[:, 0])[0][:, None]
    else:
        skeys = keys[lexsort(keys)]
    is_end, counts = _marks_runlens(skeys, n_valid)
    ukeys = skeys[is_end]
    return ukeys, counts[is_end], int(ukeys.shape[0])


def merge_counts(keys_a, counts_a, keys_b, counts_b):
    """Merge two unique-count tables (concat + sort + segment sum)."""
    return sort_dedup_sum(torch.cat([keys_a, keys_b]),
                          torch.cat([counts_a.to(torch.int64),
                                     counts_b.to(torch.int64)]))


def compact_mask(keys: torch.Tensor, keep: torch.Tensor):
    """Kept rows of a sorted unique table, order preserved: (keys, n)."""
    out = keys[keep]
    return out, int(out.shape[0])


def filter_by_count(keys: torch.Tensor, counts: torch.Tensor, n: int,
                    cutoff: int):
    """Rows with count >= cutoff among the first n (count.py:531)."""
    keep = counts[:n] >= cutoff
    return keys[:n][keep], counts[:n][keep], int(keep.sum())


def occurrence_histogram(counts: torch.Tensor) -> torch.Tensor:
    """hist[occ] = #distinct k-mers seen occ times, occ in
    0..MAX_OCCURRENCE (counter.h:209-212); zero counts are not counted."""
    c = counts[counts > 0].clamp(max=MAX_OCCURRENCE)
    return torch.bincount(c, minlength=MAX_OCCURRENCE + 1)


def histogram_host(hist: torch.Tensor) -> np.ndarray:
    """The histogram as the JAX package hands it to host code (int32)."""
    return hist.cpu().numpy().astype(np.int32)


def count_codes(codes: torch.Tensor, k: int):
    """Count canonical k-mers of one (R, L) code batch (count.py:403)."""
    from .kmer import extract_canonical_kmers
    keys, valid = extract_canonical_kmers(codes, k)
    return count_lanes_fused(keys.reshape(-1, keys.shape[-1]))


def count_reads_partitioned(reads, k: int, n_parts: int):
    """Multi-pass partitioned counting under the -m budget (count.py:815).

    Pass p keeps only the windows whose key falls in partition p, chosen by
    the top bits of word 0 exactly as count_batch_partition does (so every
    partition is a contiguous key range), sorts and counts them, and the
    sorted partitions concatenate. `reads` is an assemble_core.StagedReads.
    Returns (keys (n, L), counts (n,) int64) saturated at MAX_OCCURRENCE."""
    assert n_parts & (n_parts - 1) == 0, "n_parts must be a power of two"
    bits = max(n_parts.bit_length() - 1, 0)
    shift = 32 - min(2 * k, 32)
    parts_k, parts_c = [], []
    for p in range(n_parts):
        keys, _n_valid = reads.kmers(k)
        flat = keys.reshape(-1, keys.shape[-1])
        del keys
        if bits:
            w0 = (flat[:, 0] >> 32) + (1 << 31)
            top = ((w0 << shift) & 0xFFFFFFFF) >> (32 - bits)
            flat = flat[(top == p) & ~is_sentinel(flat)]
        uk, uc, un = count_lanes_fused(flat)
        if un:
            parts_k.append(uk)
            parts_c.append(uc)
    L = -(-num_words(k) // 2)
    if not parts_k:
        return (torch.zeros((0, L), dtype=torch.int64, device=reads.device),
                torch.zeros(0, dtype=torch.int64, device=reads.device))
    return torch.cat(parts_k), torch.cat(parts_c)


# ---------------------------------------------------------------------------
# host helpers, lifted from ops/count.py:581-780
# ---------------------------------------------------------------------------

def left_local_minimal_value(hist: np.ndarray, window_size: int = 1) -> int:
    """First local minimum of the smoothed occurrence histogram
    (getLeftLocalMinimalValue, counter.h:243-266)."""
    hist = np.asarray(hist)
    max_occ = int(np.max(np.nonzero(hist)[0])) if hist.any() else 0
    if max_occ <= window_size:
        return 0
    window_vector_size = max_occ - window_size + 2
    window = np.zeros(window_vector_size, dtype=np.uint64)
    for i in range(window_size):
        window[1] += hist[1 + i]
    i = 2
    while i < window_vector_size:
        window[i] = window[i - 1] - hist[i - 1] + hist[i + window_size - 1]
        if window[i] >= window[i - 1]:
            break
        i += 1
    if i <= max_occ:
        return i - 1 + window_size // 2
    return 1 + window_size // 2


def coverage_cutoff(hist: np.ndarray, manual: int = 0, repeat_mode: bool = False,
                    window_size: int = 1) -> int:
    """assemble.cpp:319-321: -n override, else max(localMin/2, 2)
    (or max(localMin, 2) in repeat mode)."""
    if manual:
        return int(manual)
    lm = left_local_minimal_value(hist, window_size)
    return max(lm if repeat_mode else lm // 2, 2)


def distribution_average(hist: np.ndarray, start: int, end: int) -> float:
    """calcDistributionAverage (counter.h:219-237): mean occurrence of
    distinct k-mers in [start, end]."""
    hist = np.asarray(hist, dtype=np.float64)
    end = min(end, len(hist) - 1)
    idx = np.arange(start, end + 1)
    num = float(hist[start:end + 1].sum())
    if num == 0:
        raise ValueError("empty k-mer distribution range")
    return float((idx * hist[start:end + 1]).sum() / num)


def write_occurrence_tsv(path: str, hist: np.ndarray) -> None:
    """PREFIX_<k>merFrq.tsv (counter.h:999-1007 outputOccurrenceDistribution)."""
    hist = np.asarray(hist)
    max_occ = int(np.max(np.nonzero(hist)[0])) if hist.any() else 0
    with open(path, "w") as f:
        for occ in range(1, max_occ + 1):
            f.write(f"{occ}\t{int(hist[occ])}\n")


_INTERNAL_OCC_MAGIC = 0x5054_5055_4F43_4331  # "PTPUOCC1" tag for k>32 files

# common.cpp:34
DOUBLE_HASH_MAX_LOAD_FACTOR = 0.9


def _doublehash_params(table_len: int):
    """indexLength/shifter exactly as DoubleHash (doubleHash.h:107-116,99)."""
    index_length = 1
    while table_len >> index_length != 0:
        index_length += 1
    shifter = 0 if index_length >= 32 else 2 * index_length
    return index_length, shifter


def _doublehash_slots(key64: np.ndarray, table_len: int) -> np.ndarray:
    """Slot of every (unique) u64 key in a DoubleHash of `table_len`
    (doubleHash.h:118-146,170-185), placed in parallel greedy rounds."""
    L, S = _doublehash_params(table_len)
    mask = np.uint64(table_len - 1)
    key = key64.astype(np.uint64)
    h = (key + (key >> np.uint64(L)) + (key >> np.uint64(S))) & mask
    step = (~key ^ (key >> np.uint64(L)) ^ (key >> np.uint64(S))) \
        | np.uint64(1)
    slot = np.full(len(key), -1, dtype=np.int64)
    occupied = np.zeros(table_len, dtype=bool)
    pending = np.arange(len(key))
    pos = h.copy()
    while len(pending):
        p = pos[pending]
        free = ~occupied[p]
        cand = pending[free]
        cp = pos[cand]
        _uniq, first = np.unique(cp, return_index=True)
        winners = cand[first]
        slot[winners] = pos[winners]
        occupied[pos[winners]] = True
        won = np.zeros(len(key), dtype=bool)
        won[winners] = True
        pending = pending[~won[pending]]
        pos[pending] = (pos[pending] + step[pending]) & mask
    return slot


def pack_key64(keys: np.ndarray) -> np.ndarray:
    """(N, W<=2) uint32 multiword keys -> u64 scalars (word 0 = high)."""
    k = np.asarray(keys).astype(np.uint64)
    if k.ndim == 1:
        return k
    if k.shape[1] == 1:
        return k[:, 0]
    return (k[:, 0] << np.uint64(32)) | k[:, 1]


def write_occurrence_table_binary(path: str, keys: np.ndarray,
                                  counts: np.ndarray, k: int) -> None:
    """out_kmer_occ.bin export (count.py:698): the reference DoubleHash
    format for k <= 32, the magic-tagged internal format above. keys are
    (N, W) uint32 words."""
    keys = np.asarray(keys)
    counts = np.clip(np.asarray(counts), 0, 0xFFFF).astype(np.uint16)
    with open(path, "wb") as f:
        f.write(np.uint64(k).tobytes())
        if k <= 32:
            key64 = pack_key64(keys)
            n = len(key64)
            table_len = 1
            while table_len * DOUBLE_HASH_MAX_LOAD_FACTOR < max(n, 1):
                table_len <<= 1
            slots = _doublehash_slots(key64, table_len)
            order = np.argsort(slots)
            rec = np.zeros(n, dtype=np.dtype(
                [("slot", "<u8"), ("key", "<u8"), ("val", "<u2")],
                align=False))
            rec["slot"] = slots[order]
            rec["key"] = key64[order]
            rec["val"] = counts[order]
            f.write(np.uint64(table_len - 1).tobytes())
            f.write(rec.tobytes())
        else:
            w = keys.shape[1] if keys.ndim > 1 else 1
            f.write(np.uint64(_INTERNAL_OCC_MAGIC).tobytes())
            f.write(np.uint64(len(keys)).tobytes())
            f.write(np.uint64(w).tobytes())
            f.write(keys.astype(np.uint32).tobytes())
            f.write(counts.tobytes())


def read_occurrence_table_binary(path: str):
    """Inverse of write_occurrence_table_binary (count.py:742; also reads
    tables written by the reference binary for k <= 32); returns (k, keys
    (N, W) u32 words sorted, counts (N,) u32)."""
    with open(path, "rb") as f:
        k = int(np.frombuffer(f.read(8), np.uint64)[0])
        second = np.frombuffer(f.read(8), np.uint64)[0]
        if k > 32 and second == _INTERNAL_OCC_MAGIC:
            n = int(np.frombuffer(f.read(8), np.uint64)[0])
            w = int(np.frombuffer(f.read(8), np.uint64)[0])
            keys = np.frombuffer(f.read(4 * n * w),
                                 np.uint32).reshape(n, w).copy()
            counts = np.frombuffer(f.read(2 * n),
                                   np.uint16).astype(np.uint32)
            return k, keys, counts
        # reference DoubleHash format: {u64 slot, u64 key, u16 value}*
        rec = np.frombuffer(f.read(), dtype=np.dtype(
            [("slot", "<u8"), ("key", "<u8"), ("val", "<u2")], align=False))
        key64 = rec["key"].astype(np.uint64)
        counts = rec["val"].astype(np.uint32)
        order = np.argsort(key64, kind="stable")
        key64, counts = key64[order], counts[order]
        W = num_words(k)
        keys = np.zeros((len(key64), W), dtype=np.uint32)
        if W == 1:
            keys[:, 0] = key64.astype(np.uint32)
        else:
            keys[:, 0] = (key64 >> np.uint64(32)).astype(np.uint32)
            keys[:, 1] = (key64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        return k, keys, counts
