"""`gap_close` command: close scaffold gaps by local re-assembly.

CLI surface mirrors the reference (gapClose.cpp:52-126). Flow per
gapClose.cpp:131-295: map PE libraries onto scaffolds, estimate insert
sizes, build the gap table, collect mate reads in gap windows per library,
close each gap (DBG first, OLC fallback, partial close), then emit
PREFIX_gapClosed_<input>. `-extend` and `_extraContig.fa` local assembly
are deferred (documented).

Counterpart of platanus_b_tpu/commands/gap_close_cmd.py: the per-gap local
assemblies are the port's copy of the host module models/gap_close.py
(whose `-eo >= 2` OLC path reaches the port's models/hetero.py); the read
mapping is the port's.
"""

from __future__ import annotations

import os

import numpy as np

from ..device import select_device
from ..io import fasta as fa
from ..models import gap_close as gc
from ..models import seqlib
from ..models.mapper import ContigIndex, map_reads
from ..utils.errors import ArgError, IOError_
from ..utils.log import LOG


def add_parser(sub) -> None:
    p = sub.add_parser("gap_close", help="close gaps by local assembly")
    p.add_argument("-o", default="out", help="output prefix")
    p.add_argument("-c", nargs="+", default=[], help="scaffold FASTA files")
    p.add_argument("-f", nargs="+", default=[], help="single-end read files")
    p.add_argument("-s", nargs="+", type=int, default=[32],
                   help="mapping seed lengths")
    p.add_argument("-k", type=int, default=32, help="OLC seed length")
    p.add_argument("-vo", type=int, default=32, help="min overlap (OLC)")
    p.add_argument("-vd", type=int, default=32, help="min overlap (DBG)")
    p.add_argument("-d", type=int, default=1000, help="max reads for OLC")
    p.add_argument("-eo", type=int, default=1, help="max edit distance (OLC)")
    p.add_argument("-ed", type=float, default=0.01, help="max miss rate (DBG)")
    p.add_argument("-ro", type=float, default=0.66, help="min consensus (OLC)")
    p.add_argument("-rs", type=float, default=0.9, help="min consensus (single)")
    p.add_argument("-close_small_gaps", action="store_true",
                   help="consensus-close small gaps from -f single reads "
                        "(disabled in the reference binary)")
    p.add_argument("-circularize", action="store_true",
                   help="trim self-overlaps of circular sequences "
                        "(disabled in the reference binary)")
    p.add_argument("-a", action="store_true", help="disable pair gap close")
    p.add_argument("-no_partial", action="store_true")
    p.add_argument("-extend", action="store_true")
    p.add_argument("-reduce_redundancy", action="store_true")
    p.add_argument("-t", type=int, default=1, help="threads (parity)")
    p.add_argument("-tmp", default=".", help="tmp dir (parity)")
    p.set_defaults(func=run)


def close_gaps(scaffolds, libs, seed_lengths=(32,), min_overlap_olc=32,
               min_overlap_dbg=32, olc_threshold=1000, max_edit_olc=1,
               max_miss_dbg=0.01, min_consensus_olc=0.66,
               no_partial=False, disable_pair=False, extend=False,
               single_reads=None, close_small=False,
               consensus_single=0.9, device="cpu"):
    """Run the full per-library gap-close loop; mutates nothing, returns
    (closed scaffold seqs, gap list)."""
    if extend:
        # ADD_N_EDGE (common.h:577-591): one N pad at each end creates
        # edge gaps that the extendEdge path can grow
        scaffolds = [np.concatenate([np.full(1, 4, np.uint8), s,
                                     np.full(1, 4, np.uint8)])
                     for s in scaffolds]
    index = ContigIndex(scaffolds, key_length=32, device=device)
    gaps = gc.make_gap_table(scaffolds)
    LOG.counter("NUM_GAPS_TOTAL", len(gaps))

    # -f single reads: small-gap spanning segments (mapSmallGap,
    # gapClose.cpp:194-198; the consuming closeSmallGaps is disabled in
    # the reference at :225 — close_small opts in)
    if single_reads is not None and gaps:
        LOG.info("[SINGLE_LIBRARY]")
        s_codes, s_lens = single_reads
        records = gc.map_small_gap(scaffolds, s_codes, s_lens,
                                   seed_length=32)
        if close_small:
            gc.close_small_gaps(gaps, scaffolds, records,
                                consensus_rate=consensus_single)

    if not gaps or disable_pair:
        return gc.generate_gap_closed_seqs(scaffolds, gaps), gaps

    prev_ins = 0
    for li, lib in enumerate(libs):
        LOG.info(f"[PAIR_LIBRARY {li + 1}]")
        with LOG.stage("  gap_close: map reads"):
            fid, foff = map_reads(index, lib.fwd_codes, lib.fwd_lengths,
                                  tuple(seed_lengths))
            rid, roff = map_reads(index, lib.rev_codes, lib.rev_lengths,
                                  tuple(seed_lengths))
        # insert size from same-contig innie pairs
        same = (fid != 0) & (fid == -rid)
        ins = np.where(fid > 0, roff - foff + 1, foff - roff + 1)
        keep = same & (ins >= np.minimum(lib.fwd_lengths, lib.rev_lengths))
        if keep.any():
            dist = seqlib.insert_distribution(ins[keep])
            avg, sd = seqlib.estimate_ins_size(dist, min_peak_threshold=prev_ins)
            lib.average_insert, lib.sd_insert = avg, sd
            prev_ins = avg
        tol = int(lib.sd_insert * gc.SD_RATIO_MAPPED_GAP)

        LOG.info("saving reads covering gaps...")
        # each mapped end contributes its MATE
        with LOG.stage("  gap_close: collect gap reads"):
            gc.collect_gap_reads(gaps, scaffolds, fid, foff, lib.rev_codes,
                                 lib.rev_lengths, int(lib.average_insert),
                                 tol)
            gc.collect_gap_reads(gaps, scaffolds, rid, roff, lib.fwd_codes,
                                 lib.fwd_lengths, int(lib.average_insert),
                                 tol)

        LOG.info("assembling localized reads...")
        import time as _time
        _t0 = _time.perf_counter()
        n_dbg = n_olc = n_part = n_ext = 0
        for g in gaps:
            if g.state == gc.CLOSED:
                continue
            if not g.reads:
                continue
            scaf_len = len(scaffolds[g.scaffold_id - 1])
            if g.start == 0 or g.end == scaf_len:
                # scaffold-edge gap -> extension (gapClose.cpp:754-760)
                if gc.dbg_extend_edge(g, scaf_len,
                                      min_overlap=min_overlap_dbg,
                                      max_miss_rate=max_miss_dbg):
                    n_ext += 1
                continue
            if gc.dbg_close_gap(g, min_overlap=min_overlap_dbg,
                                max_miss_rate=max_miss_dbg,
                                allow_partial=False):
                n_dbg += 1
                continue
            if len(g.reads) + 2 <= olc_threshold:
                if gc.olc_close_gap(g, min_overlap=min_overlap_olc,
                                    max_edit=max_edit_olc,
                                    min_consensus=min_consensus_olc):
                    n_olc += 1
                    continue
            if not no_partial:
                if gc.dbg_close_gap(g, min_overlap=min_overlap_dbg,
                                    max_miss_rate=max_miss_dbg,
                                    allow_partial=True):
                    if g.state == gc.PART_CLOSED:
                        n_part += 1
        LOG.info(f"  gap_close: closer loop done "
                 f"({_time.perf_counter() - _t0:.2f} s)")
        LOG.counter("NUM_CLOSED_GAPS_IN_DE_BRUIJN", n_dbg)
        LOG.counter("NUM_CLOSED_GAPS_IN_OVERLAP_LAYOUT_CONSENSUS", n_olc)
        LOG.counter("NUM_CLOSED_GAPS_PARTIAL", n_part)
        if extend:
            LOG.counter("NUM_EXTENDED_EDGES", n_ext)
        # reads stay pooled on gaps for the next library pass, as in the
        # reference's leftover-read accumulation

    # all-library pooled final pass (gapClose.cpp:265-269: numLibrary > 1
    # -> one more gapCloseUsingPairReads over the pooled unused reads,
    # DBG-only with olcThreshold=0)
    if len(libs) > 1:
        LOG.info("[ALL LIBRARY]")
        n_final = 0
        for g in gaps:
            if g.state == gc.CLOSED or not g.reads:
                continue
            if len(scaffolds[g.scaffold_id - 1]) in (g.end, 0)                     or g.start == 0:
                continue
            if gc.dbg_close_gap(g, min_overlap=min_overlap_dbg,
                                max_miss_rate=max_miss_dbg,
                                allow_partial=not no_partial):
                n_final += 1
        LOG.counter("NUM_CLOSED_GAPS_ALL_LIBRARY", n_final)

    return gc.generate_gap_closed_seqs(scaffolds, gaps), gaps


def run(args) -> int:
    if not args.c:
        raise ArgError("gap_close: not specified contig (scaffold) file!! (-c)")
    if not getattr(args, "libspecs", []) and not args.f:
        raise ArgError("gap_close: not specified read file!!")

    from .libparse import load_libraries

    file_recs = []
    read_len = max_k = 0
    for path in args.c:
        if not os.path.exists(path):
            raise IOError_(f"cannot open file: {path}")
        recs = [(n, fa.seq_to_codes(s)) for n, s in fa.iter_fasta(path)]
        file_recs.append((path, recs))
        if recs and read_len == 0:
            read_len = fa.parse_read_length(recs[0][0])
            max_k = fa.parse_max_k(recs[0][0])
    scaffolds = [c for _p, recs in file_recs for _n, c in recs]
    covs = [fa.parse_cov(n) for _p, recs in file_recs for n, _c in recs]
    libs = load_libraries(args.libspecs)

    single_reads = None
    if args.f:
        from ..io.reads import load_read_batches
        mats, lens_all = [], []
        lmax = 0
        for b in load_read_batches(args.f):
            if b.num_reads:
                mats.append(b.codes)
                lens_all.append(b.lengths)
                lmax = max(lmax, b.codes.shape[1])
        if mats:
            total = sum(m.shape[0] for m in mats)
            codes = np.full((total, lmax), 4, np.uint8)
            r0 = 0
            for m in mats:
                codes[r0: r0 + m.shape[0], : m.shape[1]] = m
                r0 += m.shape[0]
            single_reads = (codes, np.concatenate(lens_all))

    device = select_device()
    LOG.info(f"device: {device}")
    closed, gaps = close_gaps(
        scaffolds, libs, seed_lengths=tuple(args.s),
        min_overlap_olc=args.vo, min_overlap_dbg=args.vd,
        olc_threshold=args.d, max_edit_olc=args.eo, max_miss_dbg=args.ed,
        min_consensus_olc=args.ro, no_partial=args.no_partial,
        disable_pair=args.a, extend=args.extend,
        single_reads=single_reads, close_small=args.close_small_gaps,
        consensus_single=args.rs, device=device)
    if args.circularize:
        gc.find_circular_seqs(closed)
    if args.extend:
        # strip leftover edge-pad Ns
        from ..models.polish import trim_edge_n
        closed = [trim_edge_n(s) for s in closed]

    # _extraContig.fa from unclosed-gap read pools (gapClose.cpp:288-290)
    extras = [e for e in gc.local_assemble_extra_contigs(gaps)
              if len(e) >= 2 * gc.BRUIJN_MAX_KMER]
    fa.write_contigs(f"{args.o}_extraContig.fa", extras,
                     [1.0] * len(extras), 1.0, read_len, max_k, prefix="seq")

    if args.reduce_redundancy:
        from ..models.scaffold import ResultSeq, mark_redundant_result_seq
        tmp = [ResultSeq(seq=s, name="", component="") for s in closed]
        mark_redundant_result_seq(tmp)
        redundant = [r.redundant for r in tmp]
    else:
        redundant = [False] * len(closed)

    from .polish_cmd import _strip_prefix
    idx = 0
    for path, recs in file_recs:
        out_name = f"{args.o}_gapClosed_{_strip_prefix(path, args.o)}"

        def gen():
            nonlocal idx
            for name, _c in recs:
                seq = closed[idx]
                red = redundant[idx]
                cov = covs[idx]
                idx += 1
                if red or len(seq) == 0:
                    continue
                j = 0
                while j < len(name) and not name[j].isdigit():
                    j += 1
                while j < len(name) and name[j].isdigit():
                    j += 1
                head = name[:j] if name else f"seq{idx}"
                yield (f"{head}_len{len(seq)}_cov{cov}_read{read_len}"
                       f"_maxK{max_k}", fa.codes_to_seq(seq))

        fa.write_fasta(out_name, gen())
    LOG.info("gap_close completed!!")
    LOG.report_memory()
    return 0
