"""`polish` command: scaffolds + PE reads -> PREFIX_polished_*.fa.

CLI surface mirrors the reference (polish.cpp:37-80); counterpart of
platanus_b_tpu/commands/polish_cmd.py.
"""

from __future__ import annotations

import os

import numpy as np

from ..device import select_device
from ..io import fasta as fa
from ..models.polish import PolishOptions, polish
from ..utils.errors import ArgError, IOError_
from ..utils.log import LOG


def add_parser(sub) -> None:
    p = sub.add_parser("polish", help="mask error-suspect bases by pileup")
    p.add_argument("-o", default="out", help="output file prefix")
    p.add_argument("-c", nargs="+", default=[], help="scaffold files (FASTA)")
    p.add_argument("-s", type=int, default=32, help="mapping seed length (0=auto)")
    p.add_argument("-e", type=float, default=0.97, help="min identity for 'ok' reads")
    p.add_argument("-r", type=float, default=1.0, help="min odd-read ratio to mask")
    p.add_argument("-l", type=int, default=0, help="min contig length (0=auto maxK)")
    p.add_argument("-t", type=int, default=1, help="threads (parity)")
    p.add_argument("-tmp", default=".", help="tmp dir (parity)")
    p.set_defaults(func=run)


def _strip_prefix(path: str, prefix: str) -> str:
    """printSeq naming (polish.cpp:462-476): the output file name is the
    input path with everything up to (and one separator after) the output
    prefix removed."""
    pos = path.find(prefix)
    pos = pos + len(prefix) if pos >= 0 else 0
    if pos < len(path) and not path[pos].isalnum():
        pos += 1
    return path[pos:].replace("/", "_")


def run(args) -> int:
    if not args.c:
        raise ArgError("polish: not specified contig file!! (-c)")
    if not getattr(args, "libspecs", []):
        raise ArgError("polish: not specified read file!!")
    for path in args.c:
        if not os.path.exists(path):
            raise IOError_(f"cannot open file: {path}")

    from .libparse import load_libraries

    # per-file contig lists so outputs mirror inputs (polish.cpp printSeq
    # writes PREFIX_polished_<inputname> per input file)
    file_recs = []
    read_length = 0
    max_k = 0
    for path in args.c:
        recs = [(n, fa.seq_to_codes(s)) for n, s in fa.iter_fasta(path)]
        file_recs.append((path, recs))
        if recs and read_length == 0:
            read_length = fa.parse_read_length(recs[0][0])
            max_k = fa.parse_max_k(recs[0][0])
    if read_length <= 1:
        read_length = 100
    if max_k <= 1:
        max_k = 100

    contigs = [c for _p, recs in file_recs for _n, c in recs]
    covs = [fa.parse_cov(n) for _p, recs in file_recs for n, _c in recs]
    libs = load_libraries(args.libspecs)

    opts = PolishOptions(seed_length=args.s, min_identity=args.e,
                         min_odd_ratio=args.r, min_contig_length=args.l)
    device = select_device()
    LOG.info(f"device: {device}")
    out, kept = polish(contigs, libs, opts, contig_max_k=max_k, device=device)

    idx = 0
    for path, recs in file_recs:
        out_name = f"{args.o}_polished_{_strip_prefix(path, args.o)}"

        def gen():
            nonlocal idx
            for name, _c in recs:
                seq = out[idx]
                idx += 1
                if len(seq) == 0:
                    continue
                # keep the leading name up to the end of its first digit run
                # (polish.cpp:491-504), re-stamp metadata
                j = 0
                while j < len(name) and not name[j].isdigit():
                    j += 1
                while j < len(name) and name[j].isdigit():
                    j += 1
                head = name[:j] if name else f"seq{idx}"
                cov = fa.parse_cov(name)
                yield (f"{head}_len{len(seq)}_cov{cov}_read{read_length}"
                       f"_maxK{max_k} pre_name:{name}", fa.codes_to_seq(seq))

        fa.write_fasta(out_name, gen())
    LOG.info("polish completed!!")
    LOG.report_memory()
    return 0
