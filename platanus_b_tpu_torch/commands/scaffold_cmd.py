"""`scaffold` command: the classic mate-pair scaffolder (scaffold.cpp).

Legacy per-library scaffolder on ScaffoldGraph (not used by iterate, which
drives solve_dbg -unphase instead): per library, tolerance-ramped
makeGraph -> deleteErroneousEdgeIterative -> deleteRepeatEdge ->
detectRepeat -> makeScaffold loops (scaffold.cpp:151-251), then
PREFIX_scaffold.fa output with MIN_SCAFFOLD_LEN=100 (scaffold.cpp:41).

Port copy of platanus_b_tpu/commands/scaffold_cmd.py: the reference's text
over the port's mapper and scaffold-family copies. One adaptation: the
contig index lies on the device of select_device().
"""

from __future__ import annotations

import numpy as np

from ..device import select_device
from ..io import fasta as fa
from ..models import seqlib
from ..models.mapper import ContigIndex
from ..models.scaffold import (MAX_TOL_FACTOR, MIN_TOL_FACTOR, ScaffoldGraph,
                               mark_redundant_result_seq)
from ..utils.errors import ArgError
from ..utils.log import LOG

MIN_SCAFFOLD_LEN = 100


def add_parser(sub) -> None:
    p = sub.add_parser("scaffold", help="classic mate-pair scaffolding")
    p.add_argument("-o", default="out", help="output prefix")
    p.add_argument("-c", nargs="+", default=[], help="contig FASTA files")
    p.add_argument("-b", nargs="+", default=[], help="bubble FASTA files")
    p.add_argument("-s", nargs="+", type=int, default=[32], help="seed lengths")
    p.add_argument("-l", type=int, default=3, help="min links")
    p.add_argument("-u", type=float, default=0.1, help="bubble threshold")
    p.add_argument("-fastg", action="store_true",
                   help="output only per-library scaffold-graph edge dumps")
    p.add_argument("-t", type=int, default=1, help="threads (parity)")
    p.add_argument("-tmp", default=".", help="tmp dir (parity)")
    p.set_defaults(func=run)


def run(args) -> int:
    from .libparse import load_libraries
    from .solve_dbg_cmd import load_contigs

    if not args.c:
        raise ArgError("scaffold: no contig file given (-c)")
    if not getattr(args, "libspecs", []):
        raise ArgError("scaffold: no read library given")
    names, seqs, covs, read_len, max_k = load_contigs(args.c)
    libs = load_libraries(args.libspecs)

    device = select_device()
    LOG.info(f"device: {device}")
    index = ContigIndex(seqs, key_length=32, device=device)
    graph = ScaffoldGraph(seqs, covs, names, min_overlap=max_k - 1,
                          hash_overlap=max_k - 1)
    graph.min_link = args.l

    mapped = []
    prev_ins = 0
    for li, lib in enumerate(libs):
        LOG.info(f"[LIBRARY {li + 1}]")
        mp = seqlib.map_pairs(index, lib, seed_lengths=tuple(args.s))
        if len(mp.insert_lengths):
            dist = seqlib.insert_distribution(mp.insert_lengths)
            avg, sd = seqlib.estimate_ins_size(dist, min_peak_threshold=prev_ins)
            lib.average_insert, lib.sd_insert = avg, sd
            prev_ins = avg
        mapped.append(mp)

    if libs:
        graph.save_overlap(index,
                           cutoff_length=int(libs[0].sd_insert * MIN_TOL_FACTOR))

    # bubble mapping + node classification (mapLibraryAndInitGraph tail,
    # scaffold.cpp:322-324: countBubble + classifyNode over HeteroMapper
    # mergeBubble positions)
    from ..models import hetero
    graph.bubble_threshold = args.u
    bubbles = []
    for path in args.b:
        for _n, s in fa.iter_fasta(path):
            bubbles.append(fa.seq_to_codes(s))
    if bubbles:
        hetero.merge_bubble(graph, bubbles)
    hetero.classify_node(graph)

    if args.fastg:
        # -fastg: per-library graph edge dump, no scaffolding
        # (Scaffold::exec scaffold.cpp:156-160 + generateGraphFastg
        # :565-575 via dumpAllEdges)
        from ..models.scaffold import dump_all_edges
        for li, lib in enumerate(libs):
            graph.lib = lib
            graph.pairs = mapped[li]
            graph.tolerence = int(MAX_TOL_FACTOR * lib.sd_insert)
            graph.min_link = args.l
            graph.make_graph()
            dump_all_edges(graph, f"{args.o}_lib{li + 1}_graph.fastg")
        LOG.info("scaffold completed!")
        return 0

    # per-library tolerance-ramped loops with hetero handling
    # (Scaffold::exec, scaffold.cpp:162-251)
    for second_pass in (False, True):
        for li, lib in enumerate(libs):
            graph.lib = lib
            graph.pairs = mapped[li]
            LOG.info(f"[LIBRARY {li + 1}] AVE_INS = {lib.average_insert}, "
                     f"SD_INS = {lib.sd_insert}")
            for tf in range(MIN_TOL_FACTOR, MAX_TOL_FACTOR + 1):
                if not second_pass:
                    graph.min_link = max(args.l, graph.estimate_link())
                else:
                    graph.min_link = args.l
                # first graph build at unlimited tolerance
                # (scaffold.cpp:179-183: setTolerence(INT64_MAX))
                graph.tolerence = 1 << 60
                graph.make_graph()
                graph.delete_thin_edge(args.l)
                graph.tolerence = int(tf * lib.sd_insert)
                hetero.remove_hetero_overlap(graph)

                LOG.counter("TOLERENCE_LEVEL_OF_CONTIG_OVERLAP",
                            graph.tolerence)
                graph.make_graph()
                graph.delete_thin_edge(args.l)
                hetero.crush_hetero_bubble(graph, graph.average_coverage)
                hetero.crush_bubble_iterative(graph, args.u,
                                              graph.average_coverage)
                graph.delete_erroneous_edge_iterative()
                if (not second_pass and li > 0) or second_pass:
                    graph.delete_repeat_edge()
                graph.detect_repeat(graph.average_coverage)
                graph.make_scaffold()

                graph.make_graph()
                graph.delete_thin_edge(args.l)
                hetero.crush_hetero_bubble(graph, graph.average_coverage)
                hetero.crush_bubble_iterative(graph, args.u,
                                              graph.average_coverage)
                hetero.delete_hetero_edge(graph)
                graph.detect_repeat(graph.average_coverage)
                graph.make_scaffold()

    graph.tolerence = int(MAX_TOL_FACTOR * libs[-1].sd_insert) if libs else max_k
    results = graph.load_result_seq(max(MIN_SCAFFOLD_LEN, read_len),
                                    read_len, max_k)
    recs = []
    for i, r in enumerate(results):
        name = r.name.replace("scaffold", "scaffold", 1)
        recs.append((name, fa.codes_to_seq(r.seq)))
    fa.write_fasta(f"{args.o}_scaffold.fa", recs)
    with open(f"{args.o}_scaffoldComponent.tsv", "w") as f:
        for r in results:
            f.write(r.component)
    # crushed bubbles -> PREFIX_scaffoldBubble.fa (printScaffoldBubble,
    # scaffoldGraph.cpp:2513-2546)
    bub_recs = []
    for bi, (codes, cov) in enumerate(graph.crushed_bubbles):
        bub_recs.append((f"seq{bi + 1}_len{len(codes)}_cov{int(cov + 0.5)}",
                         fa.codes_to_seq(codes)))
    fa.write_fasta(f"{args.o}_scaffoldBubble.fa", bub_recs)
    LOG.counter("NUM_SCAFFOLD_OUT", len(recs))
    LOG.info("scaffold completed!")
    LOG.report_memory()
    return 0
