"""`merge` command: re-assemble contig sets through a long-k DBG.

Counterpart of platanus_b_tpu/commands/merge_cmd.py (ContigMerger,
merge.cpp:70-147): contigs (split at N runs, length-filtered) are
re-k-merized at k = factor * read_length, each k-mer keeps the MAX of
max(contig coverage, -c) over its sources (counter.h:511-593
makeKmerReadDistributionFromContig), the DBG is branch-cut and
bubble-crushed, and unitigs + junction k-mers are emitted as
PREFIX_merged.fa / PREFIX_mergedJunctionKmer.fa. The k-merization is one
kmer_extract pass (assemble_core.count_from_contigs); bubble crushing runs
the edit_distance kernel.
"""

from __future__ import annotations

import os

import numpy as np

from ..device import select_device
from ..io import fasta as fa
from ..models import clean
from ..models.assemble_core import (average_coverage_excluding_outlier,
                                    build_dbg_from_table, count_from_contigs,
                                    graph_records)
from ..utils.errors import ArgError, IOError_
from ..utils.log import LOG


def add_parser(sub) -> None:
    p = sub.add_parser("merge", help="merge contig sets through a DBG")
    p.add_argument("-o", default="out", help="output prefix")
    p.add_argument("-f", nargs="+", default=[], help="contig/scaffold FASTA files")
    p.add_argument("-c", type=int, default=1, help="minimum coverage")
    p.add_argument("-k", type=float, default=1.0, help="k = factor * read_length")
    p.add_argument("-l", type=float, default=2.0,
                   help="min length = factor * read_length")
    p.add_argument("-u", type=float, default=0.0, help="bubble crush threshold")
    p.add_argument("-d", type=float, default=0.5, help="branch cut threshold")
    p.add_argument("-m", type=int, default=16, help="memory GB (parity)")
    p.add_argument("-tmp", default=".", help="tmp dir (parity)")
    p.set_defaults(func=run)


def read_contigs_cutn(paths, min_length: int):
    """readFastaCoverageCutN: split at N runs, keep pieces >= min_length,
    each piece inherits the header coverage (merge_cmd.py:44)."""
    seqs, covs, lens_all, covs_all = [], [], [], []
    for path in paths:
        if not os.path.exists(path):
            raise IOError_(f"cannot open file: {path}")
        for name, s in fa.iter_fasta(path):
            cov = fa.parse_cov(name)
            codes = fa.seq_to_codes(s)
            lens_all.append(len(codes))
            covs_all.append(cov)
            isb = codes != 4
            if not isb.any():
                continue
            d = np.diff(isb.astype(np.int8))
            starts = [0] if isb[0] else []
            starts += list(np.nonzero(d == 1)[0] + 1)
            ends = list(np.nonzero(d == -1)[0] + 1)
            if isb[-1]:
                ends.append(len(codes))
            for st, ed in zip(starts, ends):
                if ed - st >= min_length:
                    seqs.append(codes[st:ed])
                    covs.append(cov)
    return seqs, np.array(covs, np.float64), lens_all, covs_all


def run_merge(contig_files, out_prefix, k_factor=1.0, len_factor=2.0,
              min_cov=1, bubble=0.0, branch=0.5, device="cpu"):
    if not contig_files:
        raise ArgError("merge: not specified contig file!! (-f)")
    read_len = 100
    for name, _s in fa.iter_fasta(contig_files[0]):
        read_len = fa.parse_read_length(name)
        break
    k = int(k_factor * read_len + 0.5)
    min_len = int(len_factor * read_len + 0.5)
    LOG.info(f"K = {k}, loading kmers from contigs...")
    seqs, covs, lens_all, covs_all = read_contigs_cutn(contig_files, min_len)
    avg_cov = average_coverage_excluding_outlier(lens_all, covs_all)
    table = count_from_contigs(seqs, covs, k, min_cov, device)
    dbg = build_dbg_from_table(table, cutoff=0)
    clean.cut_branch_iterative(dbg, branch)
    if bubble > 0:
        clean.crush_bubble_iterative(dbg, avg_cov, bubble)

    contigs, contig_covs, junctions, junction_covs = graph_records(dbg, 1.0)
    fa.write_contigs(f"{out_prefix}_merged.fa", contigs, contig_covs, 1.0,
                     read_len, k, prefix="seq")
    fa.write_contigs(f"{out_prefix}_mergedJunctionKmer.fa", junctions,
                     junction_covs, 1.0, read_len, k, prefix="junction")
    LOG.info("merge completed!")
    return 0


def run(args) -> int:
    device = select_device()
    LOG.info(f"device: {device}")
    rc = run_merge(args.f, args.o, k_factor=args.k, len_factor=args.l,
                   min_cov=args.c, bubble=args.u, branch=args.d,
                   device=device)
    LOG.report_memory()
    return rc
