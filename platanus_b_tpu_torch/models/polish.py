"""`polish`: mask error-suspect bases by odd-read pileup ratio
(counterpart of platanus_b_tpu/models/polish.py).

Re-design of Polish (polish.h:37-86, polish.cpp):
- both ends of every pair are mapped with the ungapped-identity mapper at
  threshold 0 (mapper.cpp:1609-1770 mapPairToCalculateCoverage records the
  identity of the unique best alignment);
- per-base pileup counts reads with identity >= -e (ok) vs < -e (odd)
  (polish.cpp:243-357; odd reads increment ONLY numOddRead);
- bases where numOddRead / numRead > -r are masked to N
  (maskErrorBases polish.cpp:360-369 — note the C++ division: 0/0 = NaN
  never masks, odd/0 = +inf always masks);
- non-gap runs shorter than minContigLength are masked
  (maskShortContig :396-427), then edge Ns trimmed (trimEdgeN :430-455).

The interval pileup is a difference-array + cumsum over the concatenated
contig pool — the bulk equivalent of the reference's omp-ordered per-thread
merge (polish.cpp:298-305). It stays numpy on the host, as in the JAX
package; the mapping runs on the device (``map_reads_ungap``, the
ungap_align kernel).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils.log import LOG
from .mapper import ContigIndex, map_reads_ungap
from .seqlib import PairLibrary, estimate_ins_size, insert_distribution


@dataclass
class PolishOptions:
    """polish defaults (polish.cpp:37-50)."""

    seed_length: int = 32        # -s (0 = auto -> contigMaxK)
    min_identity: float = 0.97   # -e
    min_odd_ratio: float = 1.0   # -r
    min_contig_length: int = 0   # -l (0 = auto -> contigMaxK)


def _pileup_ranges(ids, offs, lengths, identity, min_identity,
                   starts, total_len):
    """Difference-array pileup over the concatenated contig pool."""
    ok_diff = np.zeros(total_len + 1, dtype=np.int64)
    odd_diff = np.zeros(total_len + 1, dtype=np.int64)
    mapped = ids != 0
    cid = np.abs(ids[mapped]) - 1
    off = offs[mapped]
    ln = lengths[mapped].astype(np.int64)
    fwd = ids[mapped] > 0
    cstart = starts[cid]
    cend = starts[cid + 1]
    # fwd: [offset, offset+len); rev: [offset-len+1, offset+1)
    st = np.where(fwd, off, off - ln + 1)
    ed = np.where(fwd, off + ln, off + 1)
    g_st = np.clip(cstart + np.maximum(st, 0), 0, total_len)
    g_ed = np.clip(cstart + np.minimum(ed, cend - cstart), 0, total_len)
    g_ed = np.maximum(g_ed, g_st)
    is_odd = identity[mapped] < min_identity
    np.add.at(ok_diff, g_st[~is_odd], 1)
    np.add.at(ok_diff, g_ed[~is_odd], -1)
    np.add.at(odd_diff, g_st[is_odd], 1)
    np.add.at(odd_diff, g_ed[is_odd], -1)
    return np.cumsum(ok_diff[:-1]), np.cumsum(odd_diff[:-1])


def mask_short_runs(seq: np.ndarray, min_length: int) -> np.ndarray:
    """maskShortContig (polish.cpp:396-427): N-out non-gap runs shorter
    than min_length."""
    seq = seq.copy()
    n = len(seq)
    isb = seq != 4
    if not isb.any():
        return seq
    d = np.diff(isb.astype(np.int8))
    starts = list(np.nonzero(d == 1)[0] + 1)
    ends = list(np.nonzero(d == -1)[0] + 1)
    if isb[0]:
        starts.insert(0, 0)
    if isb[-1]:
        ends.append(n)
    for s, e in zip(starts, ends):
        if e - s < min_length:
            seq[s:e] = 4
    return seq


def trim_edge_n(seq: np.ndarray) -> np.ndarray:
    """trimEdgeN (polish.cpp:430-455)."""
    nz = np.nonzero(seq != 4)[0]
    if len(nz) == 0:
        return seq[:0]
    return seq[nz[0]: nz[-1] + 1]


def polish(contigs: list[np.ndarray], libraries: list[PairLibrary],
           opts: PolishOptions, contig_max_k: int = 32,
           key_length: int = 32,
           device="cpu") -> tuple[list[np.ndarray], np.ndarray]:
    """Returns (polished contig code arrays, per-contig kept mask).

    Empty sequences (fully masked) are kept as empty arrays; the output
    writer skips them like printSeq (polish.cpp:488-489).
    """
    seed = opts.seed_length if opts.seed_length else contig_max_k
    min_contig_len = (opts.min_contig_length if opts.min_contig_length
                      else contig_max_k)
    key_length = min(seed, key_length)
    index = ContigIndex(contigs, key_length=key_length, device=device)
    total_len = int(index.starts[-1])
    ok = np.zeros(total_len, dtype=np.int64)
    odd = np.zeros(total_len, dtype=np.int64)

    for li, lib in enumerate(libraries):
        LOG.info(f"[PAIR_LIBRARY {li + 1}]")
        LOG.info("mapping reads...")
        ends = []
        for codes, lengths in ((lib.fwd_codes, lib.fwd_lengths),
                               (lib.rev_codes, lib.rev_lengths)):
            ids, offs, ident = map_reads_ungap(index, codes, lengths,
                                               min_identity=0.0,
                                               seed_length=seed)
            o, d = _pileup_ranges(ids, offs, lengths, ident,
                                  opts.min_identity, index.starts, total_len)
            ok += o
            odd += d
            ends.append((ids, offs))
        # insert-size stats for the log (polish.cpp:130-135)
        (fid, foff), (rid, roff) = ends
        same = (fid != 0) & (fid == -rid)
        ins = np.where(fid > 0, roff - foff + 1, foff - roff + 1)
        keep = same & (ins >= np.minimum(lib.fwd_lengths, lib.rev_lengths))
        if keep.any():
            avg, sd = estimate_ins_size(insert_distribution(ins[keep]))
            lib.average_insert, lib.sd_insert = avg, sd

    # maskErrorBases (polish.cpp:360-369): odd/ok > ratio; 0/0 -> NaN (no
    # mask), odd/0 -> inf (mask)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = odd.astype(np.float64) / ok.astype(np.float64)
    mask = np.zeros(total_len, dtype=bool)
    mask[np.isinf(ratio)] = True
    finite = np.isfinite(ratio)
    mask[finite] = ratio[finite] > opts.min_odd_ratio

    out = []
    n_masked = int(mask.sum())
    LOG.counter("NUM_MASKED_BASES", n_masked)
    for i, c in enumerate(contigs):
        s, e = int(index.starts[i]), int(index.starts[i + 1])
        seq = c.copy()
        seq[mask[s:e]] = 4
        seq = mask_short_runs(seq, min_contig_len)
        seq = trim_edge_n(seq)
        out.append(seq)
    kept = np.array([len(s) > 0 for s in out])
    LOG.info("polish completed!!")
    return out, kept
