"""The plain reference: what a job's outputs should say, worked out
again from the job's inputs with plain PyTorch and numpy alone.

It imports nothing of the port and takes nothing the port made: it reads
the reads and the genome the benchmark generated, and the port's output
files only to judge them (`check.py`).

- `kmer_table`: every canonical k-mer of the reads counted exactly (k <=
  32, one int64 key a window, sorted once), the occurrence distribution
  that `PREFIX_<k>merFrq.tsv` must hold row for row, and the sorted keys
  that every k-mer of a contig must be found in. With `hash_bits` the keys
  are first cut to that many bits: the control's lower precision.
- `record_coverage`: each contig's read coverage from those counts, what
  its header's cov must say.
- `k_schedule`: the k-extension schedule of Platanus_B's assemble
  (assemble.cpp's initial cutoff, average coverage and extendKmer) from
  that distribution and the mean read length: the `maxK` every header
  must carry.
- `GenomeIndex`: each contig's best placement on the genome or its reverse
  complement, by exact anchors at every genome occurrence (a repeat's
  copies each), and its mismatches there.
- `distinct_kmers`, `absent_share`: the share of one set of sequences'
  canonical k-mers (a genome's planted repeat copies) that another (the
  contigs) lacks.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MAX_OCCURRENCE = 0xFFFF - 1          # counts are held in 16 bits, one value kept
_COMP = bytes.maketrans(b"ACGT", b"TGCA")


def _window_keys(codes: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(forward, reverse-complement) int64 keys of every k-window of the
    (R, L) uint8 code rows, 2 bits a base, first base highest."""
    R, L = codes.shape
    P = L - k + 1
    fwd = torch.zeros((R, P), dtype=torch.int64, device=codes.device)
    rev = torch.zeros_like(fwd)
    for j in range(k):
        c = codes[:, j: j + P].to(torch.int64)
        fwd.bitwise_left_shift_(2).bitwise_or_(c)
        rev.bitwise_or_((3 - c).bitwise_left_shift_(2 * j))
    return fwd, rev


def canonical_keys(codes: torch.Tensor, k: int) -> torch.Tensor:
    """The canonical key of every window, one class for a k-mer and its
    reverse complement (the smaller of the two int64 keys)."""
    if not 1 <= k <= 32:
        raise ValueError(f"k = {k}: the reference keys k <= 32")
    if codes.numel() and int(codes.max()) > 3:
        raise ValueError("the reference takes reads of A, C, G and T only")
    fwd, rev = _window_keys(codes, k)
    return torch.minimum(fwd, rev).reshape(-1)


def kmer_table(reads: np.ndarray, k: int, device,
               hash_bits: int | None = None):
    """(distribution (MAX_OCCURRENCE + 1,) int64, sorted unique keys,
    their counts) of the canonical k-mers of `reads` (R, L) uint8."""
    keys = canonical_keys(torch.from_numpy(reads).to(device), k)
    if hash_bits is not None:
        # a multiplicative hash, keeping its top `hash_bits` bits
        keys = (keys * -7046029254386353131).bitwise_right_shift(
            64 - hash_bits).bitwise_and((1 << hash_bits) - 1)
    keys, _ = torch.sort(keys)
    uniq, counts = torch.unique_consecutive(keys, return_counts=True)
    del keys
    dist = torch.bincount(counts.clamp(max=MAX_OCCURRENCE),
                          minlength=MAX_OCCURRENCE + 1)
    return dist.cpu().numpy().astype(np.int64), uniq, counts


def _record_codes(seqs: list[bytes]):
    """(codes of all records end to end (uint8, 255 where not ACGT), each
    record's start, each record's length)."""
    lut = np.full(256, 255, np.uint8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)
    lens = np.array([len(x) for x in seqs], np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    return lut[np.frombuffer(b"".join(seqs), np.uint8)], starts, lens


def _forward_keys(windows: np.ndarray) -> np.ndarray:
    """int64 key of each (A, k) code row, first base highest."""
    keys = np.zeros(len(windows), np.int64)
    for j in range(windows.shape[1]):
        keys = (keys << 2) | windows[:, j].astype(np.int64)
    return keys


def _windows(seqs: list[bytes], k: int, device):
    """(canonical key of each k-window of `seqs` (ACGT text) on `device`;
    whether the window holds a base other than ACGT; the record each
    window lies in), all windows of all records in one pass; None where
    no record has a k-window."""
    codes, starts, lens = _record_codes(seqs)
    rec = np.repeat(np.arange(len(seqs)), lens)
    first = np.arange(max(len(codes) - k + 1, 0))
    first = first[first + k <= (starts + lens)[rec[first]]]
    if not len(first):
        return None
    bad = np.convolve((codes > 3).astype(np.int64), np.ones(k, np.int64),
                      "valid")[first] > 0
    clean = np.where(codes > 3, 0, codes).astype(np.uint8)
    q = canonical_keys(torch.from_numpy(clean[None, :]).to(device),
                       k)[torch.from_numpy(first).to(device)]
    return q, bad, rec[first]


def distinct_kmers(seqs: list[bytes], k: int, device) -> torch.Tensor:
    """The sorted distinct canonical k-mers of `seqs` (ACGT text), windows
    with a base other than ACGT left out."""
    win = _windows(seqs, k, device)
    if win is None:
        return torch.zeros(0, dtype=torch.int64, device=device)
    q, bad, _rec = win
    return torch.unique(q[torch.from_numpy(~bad).to(device)])


def absent_share(want: torch.Tensor, have: torch.Tensor) -> float | None:
    """The share (%) of the distinct keys `want` not among the sorted
    distinct keys `have`; None where `want` is empty."""
    if not want.numel():
        return None
    if not have.numel():
        return 100.0
    pos = torch.searchsorted(have, want).clamp(max=have.numel() - 1)
    return 100.0 * int((have[pos] != want).sum()) / want.numel()


def _window_counts(seqs: list[bytes], table_keys: torch.Tensor,
                   table_counts: torch.Tensor, k: int):
    """(count in the table of each k-window of `seqs` (ACGT text), 0 where
    absent; whether the window holds a base other than ACGT; the record
    each window lies in), all windows of all records in one pass."""
    win = _windows(seqs, k, table_keys.device)
    if win is None:
        return (np.zeros(0, np.int64), np.zeros(0, bool),
                np.zeros(0, np.int64))
    q, bad, rec = win
    if table_keys.numel():
        pos = torch.searchsorted(table_keys, q).clamp(max=table_keys.numel() - 1)
        found = (table_keys[pos] == q).cpu().numpy()
        count = table_counts[pos].cpu().numpy().astype(np.int64)
    else:
        found = np.zeros(len(rec), bool)
        count = np.zeros(len(rec), np.int64)
    count = np.where(found & ~bad, count, 0)
    return count, bad | ~found, rec


def absent_kmers(seqs: list[bytes], table_keys: torch.Tensor,
                 table_counts: torch.Tensor, k: int) -> int:
    """How many k-windows of `seqs` (ACGT text) are not in `table_keys`;
    a window with a base other than ACGT counts as absent."""
    return int(_window_counts(seqs, table_keys, table_counts, k)[1].sum())


def record_coverage(seqs: list[bytes], table_keys: torch.Tensor,
                    table_counts: torch.Tensor, k: int,
                    read_len: float) -> np.ndarray:
    """The read coverage of each record as the reads' k-mers give it: the
    mean occurrence of its k-windows (an absent one counts 0), times
    read_len / (read_len - k + 1), the k-mer to read coverage ratio. It is
    what the k-extension carries up to maxK: each larger k's count comes
    from the last k's coverage by the ratio of their window counts, and
    the header's cov converts maxK coverage back to reads. NaN where a
    record has no k-window."""
    count, _absent, rec = _window_counts(seqs, table_keys, table_counts, k)
    n = np.bincount(rec, minlength=len(seqs))
    total = np.bincount(rec, weights=count.astype(np.float64),
                        minlength=len(seqs))
    with np.errstate(invalid="ignore", divide="ignore"):
        return total / n * (read_len / (read_len - k + 1.0))


# -- the k schedule (assemble.cpp: initialKmerAssemble, extendKmer) --------

def left_local_minimum(dist: np.ndarray) -> int:
    """The first occurrence whose count is not below the next one's
    predecessor: the first local minimum of the distribution."""
    nz = np.nonzero(dist)[0]
    max_occ = int(nz[-1]) if len(nz) else 0
    if max_occ <= 1:
        return 0
    for i in range(2, max_occ + 1):
        if dist[i] >= dist[i - 1]:
            return i - 1
    return 1


def distribution_average(dist: np.ndarray, lo: int) -> float:
    occ = np.arange(len(dist), dtype=np.float64)
    part = dist[lo: MAX_OCCURRENCE + 1].astype(np.float64)
    return float((occ[lo: MAX_OCCURRENCE + 1] * part).sum() / part.sum())


def _log_p_join(cutoff: int, read_cov: float, read_len: float,
                large_k: int, small_k: int) -> float:
    """log of the Poisson chance that all the k-mers joining two k-mers
    of small_k, extended to large_k, reach the cutoff."""
    lam = read_cov * (read_len - large_k + 1.0) / read_len
    s = 0.0
    for i in range(int(cutoff)):
        s += math.exp(sum(math.log(lam) - math.log(j) for j in range(1, i + 1)))
    s = math.exp(-lam + math.log(s)) if s > 0 else 0.0
    return ((large_k - small_k) + 1.0) * (-s)


def _lowered_cutoff(cutoff: int, read_cov: float, read_len: float,
                    min_log_p: float, large_k: int, small_k: int) -> int:
    if cutoff <= 1:
        return 1
    i = cutoff
    while i > 1 and _log_p_join(i, read_cov, read_len, large_k,
                                small_k) <= min_log_p:
        i -= 1
    return i


def k_schedule(dist: np.ndarray, read_len: float, k0: int, step: int = 10,
               max_k_ratio: float = 0.5, min_coverage: int = 1,
               log_p_split: float = 10.0) -> list[int]:
    """The k of every extension step of assemble's defaults (-s 10, -K
    0.5, -c 1, -a 10), from the k0 distribution and the mean read length."""
    cutoff = max(left_local_minimum(dist) // 2, 2)
    read_cov = distribution_average(dist, cutoff) * read_len / (
        read_len - k0 + 1.0)
    min_log_p = math.log(1.0 - 10.0 ** (-log_p_split))
    min_max_k = int(read_len * max_k_ratio + 0.5)
    ks = [k0]
    while ks[-1] <= read_len:
        prev_k = ks[-1]
        k_i = prev_k
        for j in range(1, step + 2):
            k_i = prev_k + j
            cut_i = max(_lowered_cutoff(cutoff, read_cov, read_len, min_log_p,
                                        k_i, prev_k), min_coverage)
            if k_i > min_max_k and _log_p_join(
                    cut_i, read_cov, read_len, k_i, prev_k) < min_log_p:
                break
        k_i -= 1
        if k_i == prev_k:
            break
        cutoff = max(_lowered_cutoff(cutoff, read_cov, read_len, min_log_p,
                                     k_i, prev_k), min_coverage)
        ks.append(k_i)
    return ks


# -- contigs on the genome ----------------------------------------------------

def revcomp(seq: bytes) -> bytes:
    return seq.translate(_COMP)[::-1]


class GenomeIndex:
    """Every k-window of the genome, keyed on both strands, for placing
    records by exact anchors. A genome without repeats at k has one
    position a key; a planted repeat family has one a copy that the
    window's bases hold unchanged."""

    # Occurrences tried per anchor, the first in genome order. A record
    # of a repeat has to be tried on every copy, since the copies differ
    # by their divergence and only one of them may be its source; the
    # configurations plant at most tens of copies of a family, and the
    # cap keeps a key that repeats by chance in low-complexity sequence
    # from multiplying the work of every record that holds it.
    MAX_OCCURRENCES = 64

    def __init__(self, genome: bytes, k: int = 32):
        self.k, self.genome, self.genome_rc = k, genome, revcomp(genome)
        codes, _s, _l = _record_codes([genome])
        win = np.lib.stride_tricks.sliding_window_view(codes, k)
        fwd = _forward_keys(win)
        rev = _forward_keys(3 - win[:, ::-1])
        self.fwd_order = np.argsort(fwd, kind="stable")
        self.fwd = fwd[self.fwd_order]
        self.rev_order = np.argsort(rev, kind="stable")
        self.rev = rev[self.rev_order]

    def _find_all(self, keys, table, order):
        """(index into `keys`, genome position) of every occurrence of each
        key in `table`, at most MAX_OCCURRENCES a key."""
        lo = np.searchsorted(table, keys, "left")
        n = np.minimum(np.searchsorted(table, keys, "right") - lo,
                       self.MAX_OCCURRENCES)
        which = np.repeat(np.arange(len(keys)), n)
        within = np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)
        return which, order[lo[which] + within]

    def mismatches(self, seqs: list[bytes]) -> list[int | None]:
        """For each record, the fewest mismatches over the placements that
        its exact anchors (first, last and three between) put on the
        genome or its reverse complement, at every occurrence of each
        anchor (up to MAX_OCCURRENCES); None where none is found."""
        k, G = self.k, len(self.genome)
        codes, starts, lens = _record_codes(seqs)
        out: list[int | None] = [None] * len(seqs)
        rows, offs = [], []
        for i, n in enumerate(lens):
            if n < k:
                continue
            for off in sorted({0, n - k, (n - k) // 4, (n - k) // 2,
                               3 * (n - k) // 4}):
                rows.append(i)
                offs.append(off)
        if rows:
            rows, offs = np.array(rows), np.array(offs)
            idx = starts[rows] + offs
            win = codes[idx[:, None] + np.arange(k)[None, :]]
            ok = (win <= 3).all(axis=1)
            keys = _forward_keys(np.where(win > 3, 0, win))
            cands: dict[int, set] = {}
            for strand, table, order in ((0, self.fwd, self.fwd_order),
                                         (1, self.rev, self.rev_order)):
                which, pos = self._find_all(keys, table, order)
                good = ok[which]
                place = (pos - offs[which] if strand == 0
                         else G - pos - k - offs[which])
                for r, p in zip(rows[which][good], place[good]):
                    cands.setdefault(int(r), set()).add((strand, int(p)))
            for r, places in cands.items():
                s = np.frombuffer(seqs[r], np.uint8)
                n = len(s)
                for strand, p in places:
                    if p < 0 or p + n > G:
                        continue
                    g = self.genome_rc if strand else self.genome
                    mm = int((np.frombuffer(g, np.uint8, n, p) != s).sum())
                    if out[r] is None or mm < out[r]:
                        out[r] = mm
        for i, n in enumerate(lens):
            if n < k and out[i] is None:
                hit = seqs[i] in self.genome or seqs[i] in self.genome_rc
                out[i] = 0 if hit else None
        return out
