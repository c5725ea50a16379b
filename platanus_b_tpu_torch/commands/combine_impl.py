"""`solve_dbg -combine`: merge an assembly with guide contigs.

Re-design of SolveDBG::combineAssembly (solveDBG.cpp:1435-1462): guide
contigs (-gc, e.g. the round's gap-closed assembly) are aligned onto the
-c assembly like long reads (asm10-grade, identity >= -combine_i 0.9,
min length -combine_l 10000 ramped to -combine_L 100000), and the
resulting score-weighted links drive makeScaffoldCombine rounds.

Port copy of platanus_b_tpu/commands/combine_impl.py: the reference's
text, its imports resolving to the port's io.fasta, models/longread.py,
models/scaffold.py and utils. No adaptation.
"""

from __future__ import annotations

import numpy as np

from ..io import fasta as fa
from ..models.longread import LongReadAligner, alignments_to_read_records
from ..models.scaffold import ScaffoldGraph, mark_redundant_result_seq
from ..utils.errors import ArgError
from ..utils.log import LOG

def run_combine(args) -> int:
    from .solve_dbg_cmd import load_contigs, write_results

    if not args.c:
        raise ArgError("solve_dbg -combine: no contig file given (-c)")
    if not args.gc:
        raise ArgError("solve_dbg -combine: no guide contigs given (-gc)")
    # -combine_l/L/t/s/i (solveDBG.cpp:81-86)
    COMBINE_L_MIN = getattr(args, "combine_l", 10000)
    COMBINE_L_MAX = getattr(args, "combine_L", 100000)
    COMBINE_STEPS = getattr(args, "combine_s", 10)
    COMBINE_TOLERENCE = getattr(args, "combine_t", 10000)
    COMBINE_MIN_IDENTITY = getattr(args, "combine_i", 0.9)
    names, seqs, covs, read_len, max_k = load_contigs(args.c)

    guides, gnames = [], []
    for path in args.gc:
        for n, s in fa.iter_fasta(path):
            gnames.append(f"guide_{len(gnames)}_{n}")
            guides.append(fa.seq_to_codes(s))

    LOG.info("[GUIDE CONTIGS] aligning...")
    aligner = LongReadAligner(seqs, names, "asm10")
    alns = aligner.align_batch(guides, gnames)
    name_index = {n: i for i, n in enumerate(names)}

    graph = ScaffoldGraph(seqs, covs, names, min_overlap=max_k - 1,
                          hash_overlap=max_k - 1)
    graph.min_link = 1

    # length-cutoff ramp (combineAssembly :1449-1461)
    step = (COMBINE_L_MAX - COMBINE_L_MIN) // (COMBINE_STEPS - 1)
    for length_cutoff in range(COMBINE_L_MIN, COMBINE_L_MAX + 1, step):
        read_records = alignments_to_read_records(
            alns, name_index, min_alignment_length=length_cutoff,
            min_coverage=0.8, min_identity=COMBINE_MIN_IDENTITY,
            tolerence=COMBINE_TOLERENCE)
        if not read_records:
            continue
        graph.tolerence = COMBINE_TOLERENCE
        graph.make_graph_long(read_records)
        graph.delete_erroneous_edge_score(1.0)
        graph.detect_repeat(graph.average_coverage)
        graph.make_scaffold()

    graph.tolerence = COMBINE_TOLERENCE
    results = graph.load_result_seq(max_k, read_len, max_k, False)
    if args.reduce_redundancy:
        mark_redundant_result_seq(results)
    n = write_results(results, args.o, "_combined.fa",
                      "_combinedComponent.bed")
    LOG.counter("NUM_OUTPUT_SEQ", n)
    LOG.info("solve_DBG completed!")
    LOG.report_memory()
    return 0
