"""`iterate` command: the main pipeline (iterate.cpp:107-158).

In-process Python orchestration replaces the reference's fork/exec chain
(iterate.cpp builds shell command lines and system()s the same binary).
Stage order per round: merge (round>1) -> kmer_divide -> solve_dbg
-unphase -> polish -> gap_close; then a final divide + polish, and
redundancy reduction to PREFIX_iterativeAssembly.fa.

The combine rounds (solve_DBG -combine + combinatorial_gap_close.pl +
remove_redundant_seq.pl, iterate.cpp:490-549) run in-process through
models.combinatorial on top of the asm10 long-read aligner.

Port copy of platanus_b_tpu/commands/iterate_cmd.py through the port's CLI.
One adaptation: each stage runs inside LOG.stage("iterate: <stage>"), so
the stage clock holds its wall.
"""

from __future__ import annotations

import os
import shutil

import numpy as np

from ..io import fasta as fa
from ..utils.errors import ArgError, IOError_
from ..utils.log import LOG


def add_parser(sub) -> None:
    p = sub.add_parser("iterate", help="iterative assembly pipeline")
    p.add_argument("-o", default="out", help="output prefix (no '/')")
    p.add_argument("-c", nargs="+", default=[], help="contig FASTA files")
    p.add_argument("-i", type=int, default=6, help="number of iterations")
    p.add_argument("-l", type=int, default=0, help="min links to scaffold")
    p.add_argument("-u", type=float, default=0.0, help="bubble crush threshold")
    p.add_argument("-p", nargs="+", default=[], help="PacBio long reads")
    p.add_argument("-ont", nargs="+", default=[], help="ONT long reads")
    p.add_argument("-gc", nargs="+", default=[], help="guide contigs")
    p.add_argument("-t", type=int, default=1, help="threads (parity)")
    p.add_argument("-m", type=int, default=16, help="memory GB (parity)")
    p.add_argument("-tmp", default=".", help="tmp dir (parity)")
    p.add_argument("-trim_overlap", action="store_true")
    p.add_argument("-keep_file", action="store_true")
    p.set_defaults(func=run)


def _lib_argv(libspecs) -> list[str]:
    out = []
    for spec in libspecs:
        for kind, files in spec.entries:
            out.append(f"-{kind}{spec.lib_id}")
            out.extend(files)
    return out


def _restamp_len(name: str, length: int) -> str:
    import re
    return re.sub(r"len\d+", f"len{length}", name, count=1)


def _call(argv: list[str], stage: str) -> None:
    from .main import main as cli_main
    LOG.info(f"### iterate: {stage}: {' '.join(argv[:8])} ...")
    with LOG.stage(f"iterate: {stage}"):
        rc = cli_main(argv)
    if rc != 0:
        raise IOError_(f"iterate: stage '{stage}' failed with code {rc}")


def run(args) -> int:
    if not args.c:
        raise ArgError("iterate: no contig file given (-c)")
    for path in args.c:
        if not os.path.exists(path):
            raise IOError_(f"cannot open file: {path}")
    o = args.o
    if "/" in o:
        raise ArgError("iterate: do not use '/' in -o")
    libargv = _lib_argv(getattr(args, "libspecs", []))
    if not libargv:
        raise ArgError("iterate: no read library given (-IP/-ip/-OP/-op)")

    inter = f"{o}_iterateIntermediateResults"
    os.makedirs(inter, exist_ok=True)

    # countKmer (iterate.cpp:239-265): k from the contig header maxK
    max_k = 32
    for name, _s in fa.iter_fasta(args.c[0]):
        max_k = fa.parse_max_k(name)
        break
    lib_files = [t for t in libargv if not t.startswith("-")]
    _call(["assemble", "-kmer_occ_only", "-n", "1", "-k", str(max_k),
           "-o", f"{inter}/{o}", "-f"] + lib_files, "count kmers")

    prev_dir = None
    cur_dir = None
    for times in range(1, args.i + 1):
        cur_dir = f"{inter}/{o}{times}"
        os.makedirs(cur_dir, exist_ok=True)
        contig_fa = f"{cur_dir}/{o}_contig.fa"
        if times == 1:
            with open(contig_fa, "w") as out:
                for path in args.c:
                    with open(path) as f:
                        shutil.copyfileobj(f, out)
        else:
            factor = 1.0 + 0.5 * ((times - 1) // 3)
            merge_in = [f"{prev_dir}/{o}_gapClosed_polished_consensusScaffold.fa"]
            extra = f"{prev_dir}/{o}_extraContig.fa"
            if os.path.exists(extra):
                merge_in.append(extra)
            _call(["merge", "-f"] + merge_in
                  + ["-k", str(factor), "-l", str(factor),
                     "-u", str(args.u), "-o", f"{cur_dir}/{o}"],
                  f"merge (round {times})")
            with open(contig_fa, "w") as out:
                for p in (f"{cur_dir}/{o}_merged.fa",
                          f"{cur_dir}/{o}_mergedJunctionKmer.fa"):
                    with open(p) as f:
                        shutil.copyfileobj(f, out)

        _call(["kmer_divide", "-k", f"{inter}/{o}_kmer_occ.bin",
               "-f", contig_fa, "-o", f"{cur_dir}/{o}"],
              f"kmer_divide (round {times})")

        scaf_argv = ["solve_dbg", "-unphase", "-reduce_redundancy",
                     "-c", f"{cur_dir}/{o}_kmerDivided.fa",
                     "-u", str(args.u), "-o", f"{cur_dir}/{o}"] + libargv
        if args.l:
            scaf_argv += ["-l", str(args.l)]
        if times == args.i and args.trim_overlap:
            scaf_argv.append("-trim_overlap")
        # long reads / guide contigs join the scaffolding rounds once
        # times >= numTimes/2 (iterate.cpp:359-368). (The reference also
        # appears to forward -r there, iterate.cpp:344-346, but iterate
        # never registers "-r" so that branch is dead code — and
        # solve_DBG has no -r option to receive it.)
        if times >= args.i // 2:
            for flag, files in (("-p", args.p), ("-ont", args.ont),
                                ("-gc", args.gc)):
                if files:
                    scaf_argv += [flag] + list(files)
        _call(scaf_argv, f"solve_dbg -unphase (round {times})")

        _call(["polish", "-c", f"{cur_dir}/{o}_consensusScaffold.fa",
               "-o", f"{cur_dir}/{o}"] + libargv, f"polish (round {times})")

        gc_argv = ["gap_close", "-reduce_redundancy",
                   "-c", f"{cur_dir}/{o}_polished_consensusScaffold.fa",
                   "-o", f"{cur_dir}/{o}"] + libargv
        if times < args.i:
            gc_argv.append("-extend")
        _call(gc_argv, f"gap_close (round {times})")
        prev_dir = cur_dir

    # final divide + polish (iterate.cpp:401-458); -p/-ont/-gc forward
    # unconditionally here (iterate.cpp:418-426)
    div_argv = ["solve_dbg", "-divide_only",
                "-c", f"{cur_dir}/{o}_gapClosed_polished_consensusScaffold.fa",
                "-o", f"{cur_dir}/{o}_final"] + libargv
    for flag, files in (("-p", args.p), ("-ont", args.ont),
                        ("-gc", args.gc)):
        if files:
            div_argv += [flag] + list(files)
    _call(div_argv, "final divide")
    _call(["polish", "-c", f"{cur_dir}/{o}_final_divided.fa",
           "-o", f"{cur_dir}/{o}"] + libargv, "final polish")

    final_in = f"{cur_dir}/{o}_polished_final_divided.fa"

    # combine rounds (iterate.cpp:490-549): combine the final assembly with
    # each later round's gap-closed result, then combinatorial gap close and
    # redundancy removal; the last round's result is the final output
    from ..models import combinatorial as comb
    final_file = final_in
    for times in range(max(args.i // 2, 1), args.i):
        gc_file = (f"{inter}/{o}{times}/"
                   f"{o}_gapClosed_polished_consensusScaffold.fa")
        if not os.path.exists(gc_file):
            continue
        prefix = f"{cur_dir}/{o}{times}"
        _call(["solve_dbg", "-combine", "-c", final_in, "-gc", gc_file,
               "-o", prefix], f"combine (round {times})")
        base = [(n, fa.seq_to_codes(s))
                for n, s in fa.iter_fasta(f"{prefix}_combined.fa")]
        compl = [(n, fa.seq_to_codes(s)) for n, s in fa.iter_fasta(gc_file)]
        if base and compl:
            closed, _n = comb.combinatorial_gap_close(
                [c for _n2, c in base], [n for n, _c in base],
                [c for _n2, c in compl], [n for n, _c in compl])
            base = list(zip([n for n, _c in base], closed))
        fa.write_fasta(f"{prefix}_closed.fa",
                       [(n, fa.codes_to_seq(c)) for n, c in base])
        red = comb.remove_redundant([c for _n2, c in base],
                                    [n for n, _c in base])
        fa.write_fasta(f"{prefix}_closed.fa.rmred",
                       [(n, fa.codes_to_seq(c))
                        for (n, c), r in zip(base, red) if not r])
        final_file = f"{prefix}_closed.fa.rmred"

    out_recs = [(n, s) for n, s in fa.iter_fasta(final_file)]
    # re-stamp lengths in headers (close_gap.pl renames lenNNN)
    out_recs = [(_restamp_len(n, len(s)), s) for n, s in out_recs]
    fa.write_fasta(f"{o}_iterativeAssembly.fa", out_recs)
    LOG.counter("NUM_OUTPUT_SEQ", len(out_recs))

    if not args.keep_file:
        try:
            os.remove(f"{inter}/{o}_kmer_occ.bin")
        except OSError:
            pass
    LOG.info("iterate completed!!")
    LOG.report_memory()
    return 0
