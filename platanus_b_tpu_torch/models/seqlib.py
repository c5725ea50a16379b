"""Read libraries: pair mapping products, insert-size statistics and
tagged (10x) libraries (counterpart of platanus_b_tpu/models/seqlib.py).

Replaces SeqLib (seqlib.h:31-145, seqlib.cpp) and the pair-mapping batch
drivers (mapper.cpp:689-786 mapPairMT, :1265 gatherPairReadMappedSameContig,
:789 mapTagPairMT). The host numpy code is the JAX package's, unchanged;
only the mapper is the port's.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils.log import LOG
from .mapper import ContigIndex, map_reads

# seqlib.cpp:37-41
INS_DISTR_TRUNC = 0.025
INS_DISTR_TRUNC_SD_RATE = 3.0
INS_DISTR_TRUNC_NUM_ITERATION = 1000
INS_CUTOFF_RATE_TO_PEAK = 0.5
INS_PEAK_WINDOW = 101

# common.cpp:36-39
SHORT_READ_INS_SIZE_LOWER_BOUND_FACTOR = 0.25
SHORT_READ_INS_SIZE_UPPER_BOUND_FACTOR = 1.75
LONG_READ_INS_SIZE_LOWER_BOUND_FACTOR = 0.25
LONG_READ_INS_SIZE_UPPER_BOUND_FACTOR = 10.0


@dataclass
class PairLibrary:
    """One paired-end library (the reference's vector<SeqLib> row).

    fwd/rev: padded code arrays + lengths (innie -IP orientation assumed;
    outie -OP libraries are reverse-complemented at load time, matching the
    reference's read-time normalization).
    """

    fwd_codes: np.ndarray
    fwd_lengths: np.ndarray
    rev_codes: np.ndarray
    rev_lengths: np.ndarray
    average_insert: float = 0.0
    sd_insert: float = 0.0
    average_coverage: float = 0.0
    average_length: float = 0.0

    @property
    def num_pairs(self) -> int:
        return len(self.fwd_lengths)

    def total_bases(self) -> int:
        return int(self.fwd_lengths.sum() + self.rev_lengths.sum())


@dataclass
class MappedPairs:
    """Products of mapPairMT: per-pair positions + derived records."""

    fwd_id: np.ndarray
    fwd_off: np.ndarray
    rev_id: np.ndarray
    rev_off: np.ndarray
    insert_lengths: np.ndarray     # same-contig proper pairs
    link_fwd_id: np.ndarray        # different-contig pairs (link records)
    link_fwd_off: np.ndarray
    link_rev_id: np.ndarray
    link_rev_off: np.ndarray


def map_pairs(index: ContigIndex, lib: PairLibrary,
              seed_lengths=(32,), min_contig_len: int = 0) -> MappedPairs:
    """mapPairMT (mapper.cpp:689-786): map both ends, classify pairs."""
    LOG.info("mapping reads...")
    fid, foff = map_reads(index, lib.fwd_codes, lib.fwd_lengths, seed_lengths)
    rid, roff = map_reads(index, lib.rev_codes, lib.rev_lengths, seed_lengths)

    both = (fid != 0) & (rid != 0)
    same = both & (fid == -rid)
    # proper innie orientation + insert length (mapper.cpp:740-750)
    ins_f = same & (fid > 0) & (foff < roff)
    ins_r = same & (rid > 0) & (roff < foff)
    insert = np.where(ins_f, roff - foff + 1,
                      np.where(ins_r, foff - roff + 1, 0)).astype(np.int64)
    min_len = np.minimum(lib.fwd_lengths, lib.rev_lengths)
    keep_ins = (ins_f | ins_r) & (insert >= min_len)

    diff = both & (fid != rid) & ~same
    total = len(fid)
    n_same = int(keep_ins.sum())
    n_diff = int(diff.sum())
    LOG.counter("TOTAL_PAIR", total)
    LOG.counter("MAPPED_PAIR", n_same + n_diff)
    LOG.counter("MAPPED_IN_DIFFERENT_CONTIGS", n_diff)
    LOG.counter("MAPPED_IN_SAME_CONTIG", n_same)

    if n_diff:
        cov = float((lib.fwd_lengths + lib.rev_lengths).sum()) / max(
            int(index.lengths.sum()), 1)
    else:
        cov = 1.0
    lib.average_coverage = cov
    lib.average_length = (lib.total_bases() / (2.0 * lib.num_pairs)
                          if lib.num_pairs else 0.0)
    LOG.counter("AVERAGE_COVERAGE", cov)

    return MappedPairs(
        fwd_id=fid, fwd_off=foff, rev_id=rid, rev_off=roff,
        insert_lengths=insert[keep_ins],
        link_fwd_id=fid[diff], link_fwd_off=foff[diff],
        link_rev_id=rid[diff], link_rev_off=roff[diff])


# ---------------------------------------------------------------------------
# insert-size statistics (seqlib.cpp:117-364)
# ---------------------------------------------------------------------------

def insert_distribution(insert_lengths: np.ndarray) -> np.ndarray:
    """readInsertSizeFile (seqlib.cpp:288-303): histogram over observed sizes."""
    if len(insert_lengths) == 0:
        raise ValueError("No read mapped in the same contig!!")
    size = int(insert_lengths.max()) + 1
    dist = np.zeros(size, dtype=np.int64)
    np.add.at(dist, insert_lengths.astype(np.int64), 1)
    return dist


def find_distribution_peak(dist: np.ndarray, window_size: int = INS_PEAK_WINDOW,
                           min_peak_threshold: int = 0) -> int:
    """findDistributionPeak (seqlib.cpp:333-364): max window sum, center."""
    dist = np.asarray(dist)
    if len(dist) <= min(window_size, min_peak_threshold):
        return len(dist) // 2
    min_peak_threshold = max(min_peak_threshold, window_size // 2)

    pre = dist[min_peak_threshold - window_size // 2: window_size].sum()
    peak = pre
    peak_i = min_peak_threshold
    for i in range(min_peak_threshold - window_size // 2 + 1,
                   len(dist) - window_size + 1):
        cur = pre - dist[i - 1] + dist[i + window_size - 1]
        if cur > peak:
            peak = cur
            peak_i = i + window_size // 2
        pre = cur
    return int(peak_i)


def _dist_average(dist: np.ndarray, lo: int, hi: int) -> float:
    idx = np.arange(lo, hi + 1)
    w = dist[lo: hi + 1].astype(np.float64)
    n = w.sum()
    return float((idx * w).sum() / n) if n > 0 else 0.0


def _dist_sd(dist: np.ndarray, lo: int, hi: int) -> float:
    avg = _dist_average(dist, lo, hi)
    idx = np.arange(lo, hi + 1)
    w = dist[lo: hi + 1].astype(np.float64)
    n = w.sum()
    if n <= 1:
        return 0.0
    return float(np.sqrt(((idx - avg) ** 2 * w).sum() / (n - 1.0)))


def estimate_ins_size(dist: np.ndarray, min_peak_threshold: int = 0,
                      lower_bound_factor: float = SHORT_READ_INS_SIZE_LOWER_BOUND_FACTOR,
                      upper_bound_factor: float = SHORT_READ_INS_SIZE_UPPER_BOUND_FACTOR
                      ) -> tuple[int, int]:
    """estimateInsSize (seqlib.cpp:249-271): peak -> truncated mean/SD.

    Returns (average_ins, sd_ins) as the reference's rounded longs.
    """
    LOG.info("estimating insert-size...")
    peak = find_distribution_peak(dist, INS_PEAK_WINDOW, min_peak_threshold)
    upper = min(int(upper_bound_factor * peak + 0.5), len(dist) - 1)
    lower = min(int(lower_bound_factor * peak + 0.5), upper)
    avg = int(_dist_average(dist, lower, upper) + 0.5)
    sd = int(_dist_sd(dist, lower, upper) + 0.5) if avg != 0 else 0
    LOG.counter("PEAK", peak)
    LOG.counter("AVE_INS", avg)
    LOG.counter("SD_INS", sd)
    return avg, sd


def truncate_distribution_by_number(dist: np.ndarray,
                                    edge: float = INS_DISTR_TRUNC) -> np.ndarray:
    """truncateDistributionByNumber (seqlib.cpp:64-110): zero `edge`
    fraction of the mass off each tail (partial bins scaled)."""
    dist = np.asarray(dist, dtype=np.float64).copy()
    final = dist.sum() * edge
    for idx_range in (range(len(dist)), range(len(dist) - 1, -1, -1)):
        acc = 0.0
        for i in idx_range:
            acc += dist[i]
            if acc + dist[i] > final:
                dist[i] = acc - final
                break
            dist[i] = 0.0
        else:
            continue
    return dist


def truncate_distribution_by_sd(dist: np.ndarray,
                                edge: float = INS_DISTR_TRUNC_SD_RATE
                                ) -> tuple[np.ndarray, int, int]:
    """truncateDistributionBySD (seqlib.cpp:116-168): clamp the
    distribution to avg +- edge*SD.

    Faithful port including the reference's quirk: the loop recomputes
    avg/SD from the UNtruncated distribution (seqlib.cpp:143-144), so it
    converges after one iteration; INS_DISTR_TRUNC_NUM_ITERATION bounds
    the (never-reached) retry path."""
    dist = np.asarray(dist, dtype=np.float64).copy()
    if len(dist) <= 1:
        return dist, 0, len(dist)
    avg = int(_dist_average(dist, 0, len(dist) - 1) + 0.5)
    sd = int(_dist_sd_about(dist, 0, len(dist) - 1, avg) + 0.5)
    lower = int(avg - (edge * sd - 0.5))
    upper = int(avg + (edge * sd + 0.5))
    for _ in range(INS_DISTR_TRUNC_NUM_ITERATION):
        a2 = int(_dist_average(dist, 0, len(dist) - 1) + 0.5)
        if a2 == avg:
            break
        avg = a2
    dist[: max(lower, 0)] = 0
    dist[max(upper, 0):] = 0
    LOG.counter("LOWER_THRESHOLD", lower)
    LOG.counter("UPPER_THRESHOLD", upper)
    return dist, lower, upper


def _dist_sd_about(dist: np.ndarray, lo: int, hi: int, avg: float) -> float:
    idx = np.arange(lo, hi + 1)
    w = np.asarray(dist[lo: hi + 1], dtype=np.float64)
    n = w.sum()
    if n <= 1:
        return 0.0
    return float(np.sqrt(((idx - avg) ** 2 * w).sum() / (n - 1.0)))


def normalize_distribution(pre: np.ndarray,
                           seq_lengths: np.ndarray) -> np.ndarray:
    """normalizeDistribution (seqlib.cpp:216-243): divide each insert bin
    by the number of positions that could observe it, rescaled to keep the
    total mass."""
    pre = np.asarray(pre, dtype=np.float64)
    prob = np.zeros(len(pre), dtype=np.float64)
    for L in np.asarray(seq_lengths, dtype=np.int64):
        end = min(L + 1, len(pre))
        if end > 1:
            prob[1:end] += L + 1 - np.arange(1, end)
    post = np.zeros_like(pre)
    nz = prob > 0
    post[nz] = pre[nz] / prob[nz]
    post[0] = 0.0
    s_pre, s_post = pre[1:].sum(), post[1:].sum()
    if s_post > 0:
        post *= s_pre / s_post
    return post


def estimate_ins_size_normalized(dist: np.ndarray,
                                 seq_lengths: np.ndarray) -> tuple[int, int]:
    """estimateInsSizeNormalized (seqlib.cpp:274-283): normalize by
    observable positions, truncate INS_DISTR_TRUNC off the tails, then
    mean/SD over the whole range."""
    post = truncate_distribution_by_number(
        normalize_distribution(dist, seq_lengths), INS_DISTR_TRUNC)
    avg = int(_dist_average(post, 0, len(post) - 1) + 0.5)
    sd = int(_dist_sd_about(post, 0, len(post) - 1, avg) + 0.5)
    return avg, sd


def write_insert_freq_tsv(path: str, insert_lengths: np.ndarray) -> None:
    """_libN_insFreq.tsv (seqlib.cpp:308-330 printInsertSizeFreq)."""
    dist = insert_distribution(insert_lengths)
    with open(path, "w") as f:
        for i in range(1, len(dist)):
            f.write(f"{i}\t{int(dist[i])}\n")

# ----------------------------------------------------------------------
# tagged (10x Genomics linked-read) libraries
# ----------------------------------------------------------------------

TAG_START_STRING = "BX:Z:"  # tagPositionInline (seqlib.cpp:~960)


@dataclass
class TagLibrary:
    """One 10x linked-read library (-x interleaved / -X fwd+rev files).

    tags[i] is the integer barcode id of pair i (0 = untagged); the string
    -> int mapping mirrors setTagStringConverter (seqlib.cpp:984-1048),
    which assigns ranks over the sorted barcode-string set.
    """

    fwd_codes: np.ndarray
    fwd_lengths: np.ndarray
    rev_codes: np.ndarray
    rev_lengths: np.ndarray
    tags: np.ndarray
    num_tags: int = 0

    @property
    def num_pairs(self) -> int:
        return len(self.fwd_lengths)


def extract_tag(header: str) -> str:
    """BX:Z:<alnum> barcode from a full header line (tagPositionInline)."""
    pos = header.find(TAG_START_STRING)
    if pos < 0:
        return ""
    pos += len(TAG_START_STRING)
    end = pos
    while end < len(header) and header[end].isalnum():
        end += 1
    return header[pos:end]


def _iter_reads_full_header(path: str):
    """(full header line, sequence) records; FASTA or FASTQ, gz/bz2 ok."""
    from ..io.fasta import open_maybe_compressed, sniff_format

    fmt = sniff_format(path)
    with open_maybe_compressed(path) as f:
        if fmt == "fasta":
            name, chunks = None, []
            for line in f:
                line = line.rstrip("\n\r")
                if not line:
                    continue
                if line[0] == ">":
                    if name is not None:
                        yield name, "".join(chunks)
                    name, chunks = line[1:], []
                else:
                    chunks.append(line)
            if name is not None:
                yield name, "".join(chunks)
        else:
            while True:
                h = f.readline()
                if not h:
                    break
                s = f.readline().rstrip("\n\r")
                f.readline()
                f.readline()
                yield h[1:].rstrip("\n\r"), s


def load_tag_library(x_files: list[str], xx_files: list[str]) -> TagLibrary:
    """Load -x (interleaved) and -X (fwd rev pairs) tagged files
    (solveDBG.cpp:853-895 readLibrary tag branch)."""
    from ..io.fasta import seq_to_codes
    from ..io.reads import pack_reads
    from ..utils.errors import ArgError

    fwd, rev, tag_strings = [], [], []
    for path in x_files:
        recs = list(_iter_reads_full_header(path))
        if len(recs) % 2 != 0:
            raise ArgError(f"{path}: the number of read is odd in file.")
        for (h1, s1), (_h2, s2) in zip(recs[0::2], recs[1::2]):
            fwd.append(seq_to_codes(s1))
            rev.append(seq_to_codes(s2))
            tag_strings.append(extract_tag(h1))
    if len(xx_files) % 2 != 0:
        raise ArgError("-X: needs fwd/rev file pairs")
    for f1, f2 in zip(xx_files[0::2], xx_files[1::2]):
        r1 = list(_iter_reads_full_header(f1))
        r2 = list(_iter_reads_full_header(f2))
        if len(r1) != len(r2):
            raise ArgError(f"{f1}/{f2}: unequal pair counts")
        for (h1, s1), (_h2, s2) in zip(r1, r2):
            fwd.append(seq_to_codes(s1))
            rev.append(seq_to_codes(s2))
            tag_strings.append(extract_tag(h1))

    # sorted-string rank ids, 1-based; "" (no tag) -> 0
    uniq = sorted({t for t in tag_strings if t})
    conv = {t: i + 1 for i, t in enumerate(uniq)}
    tags = np.array([conv.get(t, 0) for t in tag_strings], dtype=np.int64)
    fb, rb = pack_reads(fwd), pack_reads(rev)
    LOG.counter("NUM_TAG", len(uniq))
    return TagLibrary(fb.codes, fb.lengths, rb.codes, rb.lengths,
                      tags, num_tags=len(uniq))


def count_mapped_tag_for_each_contig(index: ContigIndex, tag_lib: TagLibrary,
                                     seed_lengths=(32,)):
    """mapTagPairMT + countMappedTagForEachContig (mapper.cpp:789,
    scaffoldGraph.cpp:522-591): map both tagged ends onto contigs and count
    reads per (tag, contig). Returns (tag_ids, contig_indices, counts)."""
    LOG.info("mapping tagged reads...")
    # multi-report mapping: a tag counts on EVERY contig its reads touch
    # (mapTagPairMT uses mapReadMultiReportsMultiSeed, mapper.cpp:1803)
    from .mapper import map_reads_multi
    f_ri, fid, _fo = map_reads_multi(index, tag_lib.fwd_codes,
                                     tag_lib.fwd_lengths, seed_lengths)
    r_ri, rid, _ro = map_reads_multi(index, tag_lib.rev_codes,
                                     tag_lib.rev_lengths, seed_lengths)
    ids = np.concatenate([fid, rid])
    tags = np.concatenate([tag_lib.tags[f_ri], tag_lib.tags[r_ri]])
    keep = (ids != 0) & (tags != 0)
    cidx = np.abs(ids[keep]) - 1
    tkeep = tags[keep]
    if len(cidx) == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros(0, np.int64))
    pair = tkeep * index.num_contigs + cidx
    upair, counts = np.unique(pair, return_counts=True)
    return (upair // index.num_contigs, upair % index.num_contigs,
            counts.astype(np.int64))
