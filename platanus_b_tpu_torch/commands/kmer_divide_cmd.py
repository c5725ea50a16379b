"""`kmer_divide` command: break chimeric contigs at low-occurrence k-mers.

Counterpart of platanus_b_tpu/commands/kmer_divide_cmd.py (ContigDivider,
kmer_divide.cpp): per-position k-mer occurrences come from the `assemble
-kmer_occ_only` binary table; contigs are broken where occ < -r *
per-contig-median (decideContigBreakPoint :200-224); only pieces whose
majority of k-mers clear the cutoff are kept
(judgeMajorityGreaterOrEqualCoverage :360-372); `-mask` Ns out k-mers
above -R * overall median instead; `-recalc_cov` only re-stamps coverage.

The JAX package makes one device call per contig; here every contig goes
through one kmer_extract pass and one table lookup.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..device import select_device
from ..io import fasta as fa
from ..ops import count as cnt
from ..ops.keys import keys_from_words
from ..ops.kmer import extract_kmers_packed, pack_codes
from ..ops.search import lookup
from ..utils.errors import ArgError, IOError_
from ..utils.log import LOG


def add_parser(sub) -> None:
    p = sub.add_parser("kmer_divide",
                       help="divide sequences by k-mer occurrence")
    p.add_argument("-o", default="out", help="output prefix")
    p.add_argument("-f", nargs="+", default=[], help="contig FASTA files")
    p.add_argument("-k", default="", help="k-mer occurrence binary file")
    p.add_argument("-r", type=float, default=0.1,
                   help="divide if cov < r * median")
    p.add_argument("-R", type=float, default=2.0,
                   help="mask if cov > R * overall median (-mask)")
    p.add_argument("-recalc_cov", action="store_true")
    p.add_argument("-mask", action="store_true")
    p.add_argument("-t", type=int, default=1, help="threads (parity)")
    p.add_argument("-tmp", default=".", help="tmp dir (parity)")
    p.set_defaults(func=run)


def occurrences_per_position(seqs: list[np.ndarray], k: int,
                             table_keys: torch.Tensor,
                             table_counts: np.ndarray) -> list[np.ndarray]:
    """Per-position canonical k-mer occurrence of every sequence (N windows
    and absent k-mers -> 0), getOccurrenceArray (kmer_divide.cpp:150-197).

    The sequences are laid end to end with one N between neighbours, so no
    window crosses a boundary, and the whole set is one kmer_extract pass
    and one lookup. Sequences shorter than k give empty arrays."""
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    out = [np.zeros(0, dtype=np.int64) for _ in seqs]
    sel = np.flatnonzero(lens >= k)
    if len(sel) == 0:
        return out
    starts = np.cumsum(lens[sel] + 1) - (lens[sel] + 1)
    total = int((lens[sel] + 1).sum())
    buf = np.full(-(-total // 32) * 32, 4, dtype=np.uint8)
    for i, st in zip(sel, starts):
        buf[st: st + lens[i]] = seqs[i]
    dev = table_keys.device
    words, nmask = pack_codes(torch.from_numpy(buf[None, :]).to(dev))
    keys, _n = extract_kmers_packed(words, k, nmask=nmask, max_len=total)
    keys = keys[0]
    idx = lookup(table_keys, keys).cpu().numpy()
    # an invalid window holds the SENTINEL key, which is never in a table
    # of canonical keys
    occ = np.zeros(len(idx), dtype=np.int64)
    found = idx >= 0
    occ[found] = table_counts[idx[found]]
    for i, st in zip(sel, starts):
        out[i] = occ[st: st + lens[i] - k + 1]
    return out


def run(args) -> int:
    if not args.f:
        raise ArgError("kmer_divide: not specified contig file!! (-f)")
    if not args.k or not os.path.exists(args.k):
        raise IOError_(f"cannot open k-mer occurrence file: {args.k}")

    device = select_device()
    LOG.info(f"device: {device}")
    k, keys, counts = cnt.read_occurrence_table_binary(args.k)
    table_keys = keys_from_words(keys, device)

    recs = []
    read_len = max_k = 0
    for path in args.f:
        if not os.path.exists(path):
            raise IOError_(f"cannot open file: {path}")
        for name, s in fa.iter_fasta(path):
            recs.append((name, fa.seq_to_codes(s)))
            if read_len == 0:
                read_len = fa.parse_read_length(name)
                max_k = fa.parse_max_k(name)

    occs = occurrences_per_position([c for _n, c in recs], k, table_keys,
                                    counts)

    if args.mask:
        allocc = np.concatenate([o for o in occs if len(o)]) if occs else np.zeros(1)
        med_all = int(np.sort(allocc)[len(allocc) // 2]) if len(allocc) else 0
        threshold = med_all * args.R
        LOG.counter("OVERALL_MEDIAN_COVERAGE", med_all)
        LOG.counter("COVERAGE_THRESHOLD", threshold)
        out = []
        for (name, c), o in zip(recs, occs):
            c = c.copy()
            for j in np.nonzero(o > threshold)[0]:
                c[j: j + k] = 4
            out.append((name, fa.codes_to_seq(c)))
        fa.write_fasta(f"{args.o}_kmerMasked.fa", out)
        LOG.info("divide completed")
        return 0

    rate = float("inf") if args.recalc_cov else args.r
    out_name = (f"{args.o}_recalc.fa" if args.recalc_cov
                else f"{args.o}_kmerDivided.fa")
    out = []
    seq_id = 0
    for (name, c), o in zip(recs, occs):
        seq_id += 1
        if len(o) == 0:
            continue
        med = int(np.sort(o)[len(o) // 2])
        cutoff = med * rate if not args.recalc_cov else 0.0
        bps = {0, len(o)}
        if cutoff > 0:
            low = np.nonzero(o < cutoff)[0]
            for j in low:
                bps.add(int(j))
                bps.add(int(j) + 1)
        bps = sorted(bps)
        maj_cut = max(med * (args.r if not args.recalc_cov else 1.0), 1.0)
        for st, ed in zip(bps[:-1], bps[1:]):
            if ed - st <= 0:
                continue
            if not args.recalc_cov:
                n_ok = int((o[st:ed] >= maj_cut).sum())
                if n_ok < (ed - st) / 2:
                    continue
            kmer_cov = float(o[st:ed].mean())
            read_cov = int(kmer_cov * read_len / max(read_len - k + 1, 1) + 0.5)
            piece = c[st: ed + k - 1]
            hdr = (f"seq{seq_id}_len{len(piece)}_cov{read_cov}"
                   f"_read{read_len}_maxK{max_k}")
            out.append((hdr, fa.codes_to_seq(piece)))
    fa.write_fasta(out_name, out)
    LOG.info("divide completed")
    LOG.report_memory()
    return 0
