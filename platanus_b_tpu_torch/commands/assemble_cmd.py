"""`assemble` command: reads -> PREFIX_contig.fa (+ kmerFrq.tsv, kmer_occ.bin).

Same flags, defaults and output files as platanus_b_tpu's assemble
(commands/assemble_cmd.py, assemble.cpp:55-109).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from .. import kernels
from ..device import select_device
from ..io import fasta as fa
from ..io.reads import load_read_batches
from ..models.assemble_core import (AssembleOptions, assemble,
                                    assemble_repeat)
from ..ops import count as cnt
from ..parallel import multihost as mh
from ..utils.errors import ArgError, IOError_
from ..utils.log import LOG


def add_parser(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser("assemble", help="assemble reads into contigs")
    p.add_argument("-o", default="out", help="output file prefix")
    p.add_argument("-f", nargs="+", default=[], help="read files (FASTA/FASTQ, gz/bz2 ok)")
    p.add_argument("-k", type=int, default=32, help="initial k-mer size")
    p.add_argument("-K", type=float, default=0.5, help="max-k factor of read length")
    p.add_argument("-s", type=int, default=10, help="k step size")
    p.add_argument("-n", type=int, default=0, help="initial k-mer coverage cutoff (0=auto)")
    p.add_argument("-c", type=int, default=1, help="min k-mer coverage")
    p.add_argument("-a", type=float, default=10.0, help="k-mer extension safety level")
    p.add_argument("-u", type=float, default=0.0, help="bubble crush max dissimilarity")
    p.add_argument("-d", type=float, default=0.5, help="branch cut max coverage ratio")
    p.add_argument("-e", type=float, default=0.0, help="k-mer coverage depth (0=auto)")
    p.add_argument("-t", type=int, default=1, help="threads (accepted for CLI parity)")
    p.add_argument("-m", type=int, default=16, help="memory limit GB")
    p.add_argument("-tmp", default=".", help="tmp dir (parity)")
    p.add_argument("-kmer_occ_only", action="store_true",
                   help="only output k-mer occurrence table")
    p.add_argument("-repeat", action="store_true", help="repeat mode")
    p.add_argument("-divide_straight", action="store_true",
                   help="divide unitigs at read-uncovered positions "
                        "(disabled in the reference binary)")
    p.set_defaults(func=run)


def run(args) -> int:
    if not args.f:
        raise ArgError("assemble: no read file given (-f)")
    for path in args.f:
        if not os.path.exists(path):
            raise IOError_(f"cannot open read file: {path}")
    device = select_device()
    LOG.info(f"device: {device}")

    opts = AssembleOptions(
        k=args.k, max_k_ratio=args.K, step=args.s, min_coverage=args.c,
        manual_cutoff=args.n, log_p_split=args.a, bubble_threshold=args.u,
        branch_threshold=args.d, fixed_average_coverage=args.e,
        repeat_mode=args.repeat, kmer_occ_only=args.kmer_occ_only,
        memory_gb=float(args.m), divide_straight=args.divide_straight)

    files = args.f
    if mh.process_count() > 1:
        # ingest sharding: this rank reads only its slice — compressed
        # files whole, round-robin; plain files by byte range at record
        # boundaries when large, else whole; the counting stage merges the
        # ranks' tables (parallel/multihost.py)
        splittable = [p for p in args.f if not fa.is_compressed(p)]
        whole = [p for p in args.f if fa.is_compressed(p)]
        files = (mh.host_read_plan(splittable)
                 + [(p, 0, -1) for p in mh.host_shard(whole)])
    with LOG.stage("loading reads"):
        batches = list(load_read_batches(files))
    # -repeat -kmer_occ_only is plain single-pass counting
    # (assemble.cpp:189-192)
    if args.repeat and not args.kmer_occ_only:
        result = assemble_repeat(batches, opts, device)
    else:
        result = assemble(batches, opts, device)

    if mh.process_count() > 1 and mh.process_index() != 0:
        # every rank holds the same result (global merges); only rank 0
        # writes, or the ranks would race on the same -o paths
        LOG.info("assemble completed (non-zero host, no output)!")
    else:
        with LOG.stage("writing outputs"):
            write_outputs(args, result)
        LOG.info("assemble completed!")
    LOG.report_memory()
    LOG.report_device_memory()
    report_rank()
    return 0


def report_rank() -> None:
    """The run's per-rank report, one JSON line on the log after the
    memory report: peak device bytes on each card, this process's kernel
    launches, its stage times, its stage records (`[name, parent, start,
    end, counters]`, the parent an index into the list or -1, the times in
    seconds since the logger started, the end null while the stage is
    still open, as an enclosing `iterate` stage is) and the seconds since
    its logger started (at import, after torch's). Under torchrun each rank
    prints its own, which is how an operator (or chip_smoke.py phase 9)
    compares the ranks."""
    if not torch.cuda.is_initialized():
        return
    peaks = {f"cuda:{d}": torch.cuda.max_memory_allocated(d)
             for d in range(torch.cuda.device_count())}
    LOG.info("#### DEVICE REPORT #### " + json.dumps(
        {"peak_allocated_bytes": peaks, "kernel_launches": kernels.LAUNCHES,
         "stage_s": LOG.timings,
         "spans": [[s.name, s.parent, s.t0 - LOG.started,
                    None if s.t1 is None else s.t1 - LOG.started,
                    s.counters] for s in LOG.spans],
         "since_start_s": time.perf_counter() - LOG.started}))


def write_outputs(args, result) -> None:
    # k-mer frequency distribution TSV (assemble.cpp:337-340)
    if result.hist0 is not None:
        cnt.write_occurrence_tsv(f"{args.o}_{result.k0}merFrq.tsv", result.hist0)

    if args.kmer_occ_only:
        keys, counts = result.kmer_table.host_words()
        cnt.write_occurrence_table_binary(f"{args.o}_kmer_occ.bin", keys,
                                          counts, result.kmer_table.k)
        return

    out = f"{args.o}_contig.fa"
    n_seq = fa.write_contigs(out, result.contigs, result.contig_covs, 1.0,
                             result.average_length, result.max_k,
                             prefix="seq")
    n_junction = fa.write_contigs(out, result.junctions, result.junction_covs,
                                  1.0, result.average_length, result.max_k,
                                  prefix="junction", append=True)
    LOG.count("records", n_seq + n_junction)
    LOG.count("junctions", n_junction)
    if result.bubbles:
        fa.write_contigs(f"{args.o}_contigBubble.fa",
                         [b.seq for b in result.bubbles],
                         [b.coverage for b in result.bubbles], 1.0,
                         result.average_length, result.max_k, prefix="seq")
