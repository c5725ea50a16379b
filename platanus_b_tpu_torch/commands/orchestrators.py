"""Thin orchestrator commands: divide, consensus, phase (L6 wrappers).

The reference implements these as fork/exec wrappers around solve_DBG /
gap_close (divide.cpp:94-127, consensus.cpp:122-131, phase.cpp:112-139);
here they are in-process calls.

Port copy of platanus_b_tpu/commands/orchestrators.py, calling the port's
CLI. No adaptation.
"""

from __future__ import annotations

import os

from ..utils.errors import ArgError, IOError_
from ..utils.log import LOG


def _lib_argv(libspecs) -> list[str]:
    out = []
    for spec in libspecs:
        for kind, files in spec.entries:
            out.append(f"-{kind}{spec.lib_id}")
            out.extend(files)
    return out


def _call(argv, stage):
    from .main import main as cli_main
    rc = cli_main(argv)
    if rc != 0:
        raise IOError_(f"{stage} failed with code {rc}")


def add_parsers(sub) -> None:
    d = sub.add_parser("divide", help="divide erroneous sequences")
    d.add_argument("-o", default="out")
    d.add_argument("-c", nargs="+", default=[])
    d.add_argument("-p", nargs="+", default=[])
    d.add_argument("-ont", nargs="+", default=[])
    d.add_argument("-gc", nargs="+", default=[])
    d.add_argument("-t", type=int, default=1)
    d.add_argument("-tmp", default=".")
    d.set_defaults(func=run_divide)

    c = sub.add_parser("consensus", help="consensus scaffolding wrapper")
    c.add_argument("-o", default="out")
    c.add_argument("-c", nargs="+", default=[])
    c.add_argument("-p", nargs="+", default=[])
    c.add_argument("-ont", nargs="+", default=[])
    c.add_argument("-l", type=int, default=3)
    c.add_argument("-u", type=float, default=0.0)
    c.add_argument("-t", type=int, default=1)
    c.add_argument("-tmp", default=".")
    c.add_argument("-reduce_redundancy", action="store_true")
    c.set_defaults(func=run_consensus)

    p = sub.add_parser("phase", help="haplotype phasing pipeline")
    p.add_argument("-o", default="out")
    p.add_argument("-c", nargs="+", default=[])
    p.add_argument("-b", nargs="+", default=[], help="bubble FASTA files")
    p.add_argument("-i", type=int, default=2)
    p.add_argument("-p", nargs="+", default=[])
    p.add_argument("-ont", nargs="+", default=[])
    p.add_argument("-x", nargs="+", default=[])
    p.add_argument("-X", nargs="+", default=[])
    p.add_argument("-t", type=int, default=1)
    p.add_argument("-tmp", default=".")
    p.add_argument("-reduce_redundancy", action="store_true")
    p.add_argument("-strict_phase", action="store_true",
                   help="strict reference-parity bubble criterion "
                        "(forwarded to solve_dbg)")
    p.set_defaults(func=run_phase)


def run_divide(args) -> int:
    """divide.cpp:94-127: wrapper over solve_DBG -divide_only."""
    if not args.c:
        raise ArgError("divide: no contig file given (-c)")
    argv = (["solve_dbg", "-divide_only", "-c"] + args.c
            + ["-o", args.o] + _lib_argv(getattr(args, "libspecs", [])))
    _call(argv, "divide")
    LOG.info("divide completed!")
    return 0


def run_consensus(args) -> int:
    """consensus.cpp:122-131: wrapper over solve_DBG -unphase."""
    if not args.c:
        raise ArgError("consensus: no contig file given (-c)")
    argv = (["solve_dbg", "-unphase", "-c"] + args.c
            + ["-o", args.o, "-l", str(args.l), "-u", str(args.u)]
            + (["-reduce_redundancy"] if args.reduce_redundancy else [])
            + _lib_argv(getattr(args, "libspecs", [])))
    _call(argv, "consensus")
    LOG.info("consensus completed!")
    return 0


def run_phase(args) -> int:
    """phase.cpp:112-155: rounds of solve_DBG (phasing flow) + gap_close.

    Per round (phase.cpp:165-283): round 1 feeds -c/-b straight through;
    later rounds feed the previous round's gap-closed nonBubbleOther as
    contigs and gap-closed primary/secondary bubbles as -b. Long reads
    (-p/-ont) join from round 2 on. The final round's gap-closed files are
    renamed to the published outputs and concatenated into
    PREFIX_allPhaseBlock.fa (phase.cpp:287-308).
    """
    import shutil

    if not args.c:
        raise ArgError("phase: no contig file given (-c)")
    libargv = _lib_argv(getattr(args, "libspecs", []))
    red = ["-reduce_redundancy"] if args.reduce_redundancy else []
    inter = f"{args.o}_intermediateResults"
    os.makedirs(inter, exist_ok=True)
    num_iterate = args.i + (1 if args.p or args.ont else 0)

    prev_prefix = None
    for t in range(1, num_iterate + 1):
        rdir = f"{inter}/round{t}"
        os.makedirs(rdir, exist_ok=True)
        prefix = f"{rdir}/{args.o}"
        if t == 1:
            cargs = ["-c"] + args.c + ((["-b"] + args.b) if args.b else [])
        else:
            cargs = ["-c", f"{prev_prefix}_gapClosed_nonBubbleOther.fa",
                     "-b", f"{prev_prefix}_gapClosed_primaryBubble.fa",
                     f"{prev_prefix}_gapClosed_secondaryBubble.fa"]
        long_argv = []
        if args.x:
            long_argv += ["-x"] + args.x
        if args.X:
            long_argv += ["-X"] + args.X
        if t > 1:
            if args.p:
                long_argv += ["-p"] + args.p
            if args.ont:
                long_argv += ["-ont"] + args.ont
        strict = (["-strict_phase"]
                  if getattr(args, "strict_phase", False) else [])
        _call(["solve_dbg"] + cargs + ["-o", prefix] + long_argv + red
              + strict + libargv, f"phase solve_dbg round {t}")
        _call(["gap_close",
               "-c", f"{prefix}_primaryBubble.fa",
               f"{prefix}_secondaryBubble.fa",
               f"{prefix}_nonBubbleOther.fa",
               f"{prefix}_nonBubbleHetero.fa",
               "-o", prefix] + red + libargv, f"phase gap_close round {t}")
        prev_prefix = prefix

    # moveAndConcatenateFinalRoundResult (phase.cpp:287-308)
    finals = [("primaryBubble", f"{args.o}_primaryBubble.fa"),
              ("secondaryBubble", f"{args.o}_secondaryBubble.fa"),
              ("nonBubbleHetero", f"{args.o}_nonBubbleHetero.fa"),
              ("nonBubbleOther", f"{args.o}_nonBubbleHomoCandidate.fa")]
    for tag, dst in finals:
        shutil.copyfile(f"{prev_prefix}_gapClosed_{tag}.fa", dst)
    with open(f"{args.o}_allPhaseBlock.fa", "w") as out:
        for _tag, dst in finals:
            with open(dst) as f:
                shutil.copyfileobj(f, out)
    LOG.info("phase completed!")
    LOG.report_memory()
    return 0
