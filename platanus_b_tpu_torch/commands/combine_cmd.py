"""`combine` command: merge assemblies guided by other assemblies/long reads.

Re-design of Combine (combine.cpp:91-135): run `solve_dbg -combine` on the
input assembly with the guide contigs, then (unless -no_gap_close) run the
combinatorial gap-close flow and redundancy removal in-process (the
reference shells out to combinatorial_gap_close.pl +
remove_redundant_seq.pl, combine.cpp:208-251), and move the final result
to PREFIX_combined.fa (combine.cpp:111-132).

Port copy of platanus_b_tpu/commands/combine_cmd.py, calling the port's
CLI. No adaptation.
"""

from __future__ import annotations

import os
import shutil

from ..io import fasta as fa
from ..utils.errors import ArgError, IOError_
from ..utils.log import LOG


def add_parser(sub) -> None:
    p = sub.add_parser("combine",
                       help="combine assemblies with guiding contigs")
    p.add_argument("-o", default="out", help="output prefix (no '/')")
    p.add_argument("-c", nargs="+", default=[], help="contig/scaffold FASTA")
    p.add_argument("-gc", nargs="+", default=[], help="guiding contig files")
    p.add_argument("-p", nargs="+", default=[], help="PacBio long reads")
    p.add_argument("-ont", nargs="+", default=[], help="ONT long reads")
    p.add_argument("-t", type=int, default=1, help="threads (parity)")
    p.add_argument("-tmp", default=".", help="tmp dir (parity)")
    p.add_argument("-no_gap_close", action="store_true",
                   help="skip gap close by guiding contigs")
    p.add_argument("-keep_file", action="store_true",
                   help="keep intermediate files")
    p.add_argument("-combine_l", type=int, default=10000,
                   help="min length cutoff in scaffolding")
    p.add_argument("-combine_L", type=int, default=100000,
                   help="max length cutoff in scaffolding")
    p.add_argument("-combine_t", type=int, default=10000,
                   help="conflict-detection tolerance")
    p.add_argument("-combine_s", type=int, default=10,
                   help="number of length-cutoff steps")
    p.add_argument("-combine_g", type=int, default=100000,
                   help="max gap size in scaffolding")
    p.add_argument("-combine_i", type=float, default=0.9,
                   help="min identity in scaffolding")
    p.set_defaults(func=run)


def _call(argv: list[str], stage: str) -> None:
    from .main import main as cli_main
    LOG.info(f"### combine: {stage}")
    rc = cli_main(argv)
    if rc != 0:
        raise IOError_(f"combine: stage '{stage}' failed with code {rc}")


def run(args) -> int:
    if not args.c:
        raise ArgError("combine: no contig file given (-c)")
    if not args.gc:
        raise ArgError("combine: no guiding contig file given (-gc)")
    if "/" in args.o:
        raise ArgError("combine: do not use '/' in -o")
    for path in args.c + args.gc:
        if not os.path.exists(path):
            raise IOError_(f"cannot open file: {path}")

    inter = f"{args.o}_combineIntermediateResults"
    os.makedirs(inter, exist_ok=True)
    prefix = f"{inter}/{args.o}"

    scaf_argv = (["solve_dbg", "-combine", "-c"] + args.c
                 + ["-gc"] + args.gc + ["-o", prefix,
                    "-combine_l", str(args.combine_l),
                    "-combine_L", str(args.combine_L),
                    "-combine_t", str(args.combine_t),
                    "-combine_s", str(args.combine_s),
                    "-combine_i", str(args.combine_i)])
    if args.p:
        scaf_argv += ["-p"] + args.p
    if args.ont:
        scaf_argv += ["-ont"] + args.ont
    _call(scaf_argv, "solve_dbg -combine")
    combined = f"{prefix}_combined.fa"

    final = combined
    if not args.no_gap_close:
        # combinatorial_gap_close.pl + remove_redundant_seq.pl equivalents
        from ..models import combinatorial as comb
        base = [(n, fa.seq_to_codes(s)) for n, s in fa.iter_fasta(combined)]
        compl = []
        for path in args.gc:
            compl.extend((n, fa.seq_to_codes(s))
                         for n, s in fa.iter_reads(path))
        if base and compl:
            closed, n_closed = comb.combinatorial_gap_close(
                [c for _n, c in base], [n for n, _c in base],
                [c for _n, c in compl], [n for n, _c in compl])
            LOG.counter("NUM_CLOSED_GAPS", n_closed)
            base = list(zip([n for n, _c in base], closed))
        fa.write_fasta(f"{prefix}_closed.fa",
                       [(n, fa.codes_to_seq(c)) for n, c in base])
        red = comb.remove_redundant([c for _n, c in base],
                                    [n for n, _c in base])
        fa.write_fasta(f"{prefix}_closed.fa.rmred",
                       [(n, fa.codes_to_seq(c))
                        for (n, c), r in zip(base, red) if not r])
        final = f"{prefix}_closed.fa.rmred"

    shutil.copyfile(final, f"{args.o}_combined.fa")
    if not args.keep_file:
        shutil.rmtree(inter, ignore_errors=True)
    LOG.counter("NUM_OUTPUT_SEQ",
                sum(1 for _ in fa.iter_fasta(f"{args.o}_combined.fa")))
    LOG.info("combine completed!!")
    LOG.report_memory()
    return 0
