"""`solve_dbg` command: PE-link consensus scaffolding (+ divide/combine).

Re-design of SolveDBG (solveDBG.cpp). Round-1 scope: the `-unphase`
consensus path used by `iterate` (solveDBG.cpp:209-228 + extendConsensus
:1177-1432), with these documented simplifications:
- overlap-join of unambiguous contig chains replaces the OVERLAP_MODE
  joinUnambiguousNodePairIterative pass;
- cross-structure resolution (solveSimpleCrossStructure*) and base-level
  erroneous-node division are deferred (phasing-oriented; the consensus
  scaffolding block below dominates isolated-genome output);
- tag (10x) libraries are not consumed.

Port copy of platanus_b_tpu/commands/solve_dbg_cmd.py: the reference's
text over the port's mapper and its copies of the scaffold-family modules.
One adaptation: the contig index lies on the device of select_device().
Long reads (-p/-ont) are aligned by the port's models/longread.py, and
-combine dispatches to the port's commands/combine_impl.py.
"""

from __future__ import annotations

import os

import numpy as np

from ..device import select_device
from ..io import fasta as fa
from ..models import seqlib
from ..models.mapper import ContigIndex
from ..models.scaffold import (MAX_TOL_FACTOR, MIN_TOL_FACTOR, ScaffoldGraph,
                               mark_redundant_result_seq)
from ..utils.errors import ArgError, IOError_
from ..utils.log import LOG

# long-read alignment gates for scaffolding decisions (solveDBG.cpp:44-46:
# MIN_LONG_READ_LENGTH_CUTOFF / MIN_IDENTITY_FOR_SCAFFOLD >= 0.8 via PAF)
MIN_IDENTITY_FOR_SCAFFOLD = 0.8


def add_parser(sub) -> None:
    p = sub.add_parser("solve_dbg", help="resolve graph structures and scaffold")
    p.add_argument("-o", default="out", help="output prefix")
    p.add_argument("-c", nargs="+", default=[], help="contig FASTA files")
    p.add_argument("-b", nargs="+", default=[], help="bubble FASTA files")
    p.add_argument("-p", nargs="+", default=[], help="PacBio long reads")
    p.add_argument("-ont", nargs="+", default=[], help="ONT long reads")
    p.add_argument("-gc", nargs="+", default=[], help="guide contigs")
    p.add_argument("-x", nargs="+", default=[],
                   help="tagged pair files, interleaved (10x Genomics)")
    p.add_argument("-X", nargs="+", default=[],
                   help="tagged pair files, fwd rev (10x Genomics)")
    p.add_argument("-L", type=int, default=200000,
                   help="max fragment length of tag (10x)")
    p.add_argument("-masked", nargs="+", default=[],
                   help="masked contig files (parity)")
    p.add_argument("-s", nargs="+", type=int, default=[32],
                   help="mapping seed lengths")
    p.add_argument("-l", type=int, default=3, help="min links to scaffold")
    p.add_argument("-k", type=int, default=1, help="min links to phase")
    p.add_argument("-v", type=int, default=32, help="min overlap for scaffolding")
    p.add_argument("-u", type=float, default=0.0, help="bubble threshold")
    p.add_argument("-e", type=float, default=0.0, help="coverage depth (0=auto)")
    p.add_argument("-t", type=int, default=1, help="threads (parity)")
    p.add_argument("-tmp", default=".", help="tmp dir (parity)")
    p.add_argument("-unphase", action="store_true", help="consensus mode")
    p.add_argument("-combine", action="store_true", help="combine mode")
    p.add_argument("-combine_l", type=int, default=10000)
    p.add_argument("-combine_L", type=int, default=100000)
    p.add_argument("-combine_t", type=int, default=10000)
    p.add_argument("-combine_s", type=int, default=10)
    p.add_argument("-combine_g", type=int, default=100000)
    p.add_argument("-combine_i", type=float, default=0.9)
    p.add_argument("-divide_only", action="store_true", help="divide mode")
    p.add_argument("-reduce_redundancy", action="store_true",
                   help="drop contained output sequences")
    p.add_argument("-trim_overlap", action="store_true",
                   help="trim overlapping scaffold edges")
    p.add_argument("-no_scaffold", action="store_true")
    p.add_argument("-strict_phase", action="store_true",
                   help="strict reference-parity phasing: bubble diamonds "
                        "only over DBG_OVERLAP-gated edges (overlap == "
                        "minOverlap exactly, pairedDBG.cpp:92,1051-1059) "
                        "with heteroCoverage preset to contigAverage/2 "
                        "(solveDBG.cpp:807); default keeps the documented "
                        "superset behavior that pairs more haplotigs")
    p.set_defaults(func=run)


def load_contigs(paths: list[str]):
    names, seqs, covs = [], [], []
    read_len, max_k = 0, 0
    for path in paths:
        if not os.path.exists(path):
            raise IOError_(f"cannot open file: {path}")
        for name, s in fa.iter_fasta(path):
            names.append(name)
            seqs.append(fa.seq_to_codes(s))
            covs.append(fa.parse_cov(name))
            if read_len == 0:
                read_len = fa.parse_read_length(name)
                max_k = fa.parse_max_k(name)
    return names, seqs, np.array(covs, np.float64), read_len, max_k


def join_unambiguous_overlaps(graph: ScaffoldGraph) -> None:
    """Overlap-chain join (simplified joinUnambiguousNodePair in
    OVERLAP_MODE, pairedDBG.cpp:1331-1431): merge NODE pairs connected by
    an end-contig overlap that is unique on both sides.

    Works at node level (a node may already hold several contigs after an
    earlier join or scaffolding round): contig-end overlaps only count
    when the contigs sit at the facing ends of their nodes.
    """
    rend: dict[int, int] = {}   # oriented contig at a node's RIGHT end
    lend: dict[int, int] = {}   # oriented contig at a node's LEFT end
    for ni, node in enumerate(graph.node, start=1):
        if not node.contigs:
            continue
        first, last = node.contigs[0][0], node.contigs[-1][0]
        lend[first] = ni
        rend[last] = ni
        lend[-last] = -ni
        rend[-first] = -ni
    out_deg: dict[int, list] = {}
    for (a, b), ov in graph.overlap_table.items():
        if ov < graph.min_overlap:
            continue
        A, B = rend.get(a), lend.get(b)
        if A is None or B is None or abs(A) == abs(B):
            continue
        out_deg.setdefault(A, []).append((B, ov))      # A's right -> B's left
        out_deg.setdefault(-B, []).append((-A, ov))    # reverse strand
    nxt = {}
    for a, lst in out_deg.items():
        if len(lst) != 1:
            continue
        b, ov = lst[0]
        back = out_deg.get(-b, [])
        if len(back) == 1:
            nxt[a] = (b, ov)

    num_nodes = len(graph.node)
    used = np.zeros(num_nodes, dtype=bool)
    chains = []
    for start in list(nxt):
        if used[abs(start) - 1]:
            continue
        # walk left to the chain head
        cur = start
        seen = {abs(cur)}
        while -cur in nxt:
            prv, _ = nxt[-cur]
            prv = -prv
            if abs(prv) in seen:
                break  # cycle
            cur = prv
            seen.add(abs(cur))
        chain = [(cur, 0)]
        seen = {abs(cur)}
        while cur in nxt:
            b, ov = nxt[cur]
            if abs(b) in seen:
                break
            chain.append((b, ov))
            seen.add(abs(b))
            cur = b
        if len(chain) > 1 and not any(used[abs(c) - 1] for c, _ in chain):
            for c, _ in chain:
                used[abs(c) - 1] = True
            chains.append(chain)

    if not chains:
        return
    new_nodes = []
    for i in range(num_nodes):
        if not used[i]:
            new_nodes.append(list(graph.node[i].contigs))
    for chain in chains:
        parts = []
        pos = 0
        for nid, ov in chain:
            shift = pos - ov
            nparts = graph._oriented_parts(nid)
            parts.extend((cid, st + shift, ed + shift)
                         for cid, st, ed in nparts)
            pos = shift + graph.node[abs(nid) - 1].length
        new_nodes.append(parts)
    graph._remake(new_nodes)
    LOG.counter("NUM_JOINED_CHAINS", len(chains))


def update_insert_size(graph: ScaffoldGraph, mp, lib) -> None:
    """updateAndWriteInsertSize (solveDBG.cpp:1341) / updateInsertLength
    (scaffoldGraph.cpp:2548): re-estimate the library insert size from
    pairs that map properly within the CURRENT scaffold nodes."""
    import numpy as np

    lift = graph.lift_arrays()
    f_sid, f_off, _fp = graph.lift_positions(mp.fwd_id, mp.fwd_off, lift)
    r_sid, r_off, _rp = graph.lift_positions(mp.rev_id, mp.rev_off, lift)
    both = (mp.fwd_id != 0) & (mp.rev_id != 0) & (f_sid != 0) & (r_sid != 0)
    same = both & (f_sid == -r_sid)
    fwd_p = same & (f_sid > 0) & (f_off < r_off)
    rev_p = same & (r_sid > 0) & (r_off < f_off)
    ins = np.where(fwd_p, r_off - f_off + 1,
                   np.where(rev_p, f_off - r_off + 1, 0))
    keep = (fwd_p | rev_p) & (ins > 0)
    if keep.sum() < 100:   # too few to re-estimate
        return
    dist = seqlib.insert_distribution(ins[keep])
    avg, sd = seqlib.estimate_ins_size(dist)
    if avg > 0:
        lib.average_insert, lib.sd_insert = avg, sd


def _setup_graph(contig_paths: list[str], libspecs, out_prefix: str,
                 min_link: int, seed_lengths=(32,), long_read_paths=(),
                 tag_x_paths=(), tag_xx_paths=(), bubble_paths=()):
    """Shared graph construction: load contigs (+optional -b bubble
    contigs, appended like readLibrary's numInputBubbleContig block),
    build the overlap table, map PE libraries, align long reads, count
    tags (mapLibraryAndInitGraph, solveDBG.cpp:642-774). Returns
    (graph, libs, mapped, read_records, avg_long_len, read_len, max_k,
    n_normal_contigs)."""
    names, seqs, covs, read_len, max_k = load_contigs(contig_paths)
    if not seqs:
        raise ArgError("solve_dbg: empty contig input")
    n_normal = len(seqs)
    if bubble_paths:
        bnames, bseqs, bcovs, _rl, _mk = load_contigs(list(bubble_paths))
        names += bnames
        seqs += bseqs
        covs = np.concatenate([covs, bcovs])
    lens = np.array([len(s) for s in seqs], dtype=np.float64)
    avg_cov = float((covs * lens).sum() / max(lens.sum(), 1.0))
    LOG.counter("CONTIG_AVERAGE_COVERAGE", avg_cov)

    from .libparse import load_libraries
    libs = load_libraries(libspecs) if libspecs else []

    device = select_device()
    LOG.info(f"device: {device}")
    index = ContigIndex(seqs, key_length=32, device=device)
    graph = ScaffoldGraph(seqs, covs, names,
                          min_overlap=max_k - 1, hash_overlap=max_k - 1,
                          seed_length=min(seed_lengths))
    graph.average_coverage = avg_cov
    graph.min_link = min_link
    graph.contig_max_k = max_k
    graph.save_overlap(index, cutoff_length=max_k)

    # map libraries once on contigs; positions are lifted per round
    mapped = []
    prev_ins = 0
    for li, lib in enumerate(libs):
        LOG.info(f"[LIBRARY {li + 1}]")
        mp = seqlib.map_pairs(index, lib, seed_lengths=tuple(seed_lengths))
        if len(mp.insert_lengths):
            dist = seqlib.insert_distribution(mp.insert_lengths)
            avg, sd = seqlib.estimate_ins_size(dist, min_peak_threshold=prev_ins)
            lib.average_insert, lib.sd_insert = avg, sd
            prev_ins = avg
            seqlib.write_insert_freq_tsv(f"{out_prefix}_lib{li + 1}_insFreq.tsv",
                                         mp.insert_lengths)
        mapped.append(mp)

    # long reads (-p/-ont): align once onto contigs; links are lifted to
    # current nodes each round (execMinimap2 + readLongReadPAFfileAndSaveLink,
    # solveDBG.cpp:697-723)
    read_records = None
    avg_long_len = 0
    if long_read_paths:
        from ..models.longread import (LongReadAligner,
                                       alignments_to_read_records)
        LOG.info("[LONG_READ_LIBRARY]")
        reads, rnames = [], []
        for path in long_read_paths:
            for n, s in fa.iter_reads(path):
                rnames.append(n)
                reads.append(fa.seq_to_codes(s))
        aligner = LongReadAligner(seqs, names, "map-ont")
        alns = aligner.align_batch(reads, rnames)
        name_index = {n: i for i, n in enumerate(names)}
        read_records = alignments_to_read_records(
            alns, name_index, min_alignment_length=1000,
            min_coverage=0.8,
            min_identity=MIN_IDENTITY_FOR_SCAFFOLD,
            tolerence=max_k)
        if read_records:
            avg_long_len = int(np.mean([rl for rl, _ in
                                        read_records.values()]))
        LOG.counter("MAPPED_READ", len(read_records))

    # tagged (10x) libraries: map once onto contigs; counts are lifted to
    # nodes per round (solveDBG.cpp:724-728,768-770)
    if tag_x_paths or tag_xx_paths:
        LOG.info("[TAG_LIBRARY]")
        tag_lib = seqlib.load_tag_library(list(tag_x_paths),
                                          list(tag_xx_paths))
        graph.set_contig_tag_counts(*seqlib.count_mapped_tag_for_each_contig(
            index, tag_lib, seed_lengths=tuple(seed_lengths)))
    return (graph, libs, mapped, read_records, avg_long_len, read_len,
            max_k, n_normal)


def run_unphase(contig_paths: list[str], libspecs, out_prefix: str,
                min_link: int = 3, min_overlap_scaf: int = 32,
                seed_lengths=(32,), reduce_redundancy: bool = False,
                trim_overlap: bool = False, long_read_paths=(),
                tag_x_paths=(), tag_xx_paths=(), phasing: bool = False):
    (graph, libs, mapped, read_records, avg_long_len, read_len, max_k,
     _n_normal) = _setup_graph(contig_paths, libspecs, out_prefix,
                               min_link, seed_lengths, long_read_paths,
                               tag_x_paths, tag_xx_paths)

    if phasing:
        # DBG bubble extraction on the initial contig graph
        # (solveDBG.cpp:266-278: extractDBGBubbleInformation x2,
        # setOppositeBubbleContigID*, crushSimpleDBGBubble via the
        # bubble-removal block)
        from ..models import hetero
        hetero.extract_dbg_bubble_information(graph, max_k)
        hetero.set_opposite_bubble_contig_id_overlapped(graph)
        hetero.crush_simple_dbg_bubble(graph)
        hetero.classify_node(graph)

    join_unambiguous_overlaps(graph)
    extend_consensus(graph, libs, mapped, read_records, avg_long_len,
                     max_k, min_link, min_overlap_scaf)

    if libs:
        graph.tolerence = int(MAX_TOL_FACTOR * libs[-1].sd_insert)
    else:
        graph.tolerence = max_k
    if phasing:
        # final hetero cleanup + node-level bubble pairing for outputs
        # (solveDBG.cpp:560-575 bubble-removal block;
        # pairedDBG.cpp:2328-2341 pairFlag scan)
        from ..models import hetero
        hetero.crush_hetero_bubble(graph, graph.average_coverage)
        hetero.delete_hetero_edge(graph)
        hetero.set_opposite_bubble_node_ids(graph)
    results = graph.load_result_seq(max_k, read_len, max_k, trim_overlap)
    if reduce_redundancy:
        mark_redundant_result_seq(results)
    return results, graph


def extend_consensus(graph, libs, mapped, read_records, avg_long_len,
                     max_k, min_link, min_overlap_scaf) -> None:
    """extendConsensus (solveDBG.cpp:1177-1432): the consensus scaffolding
    engine — cross solving, base-level division, tolerance-ramped
    scaffolding rounds, long-read scaffolding."""
    from ..models.divide import divide_erroneous_node_base_level

    for outer in range(2):
        # cross-structure resolution per library (extendConsensus
        # cross-solving block, solveDBG.cpp:1210-1256; LINK mode, then TAG
        # mode when tags are loaded — pairedDBG.cpp:1543-1640)
        for li, lib in enumerate(libs):
            graph.lib = lib
            graph.pairs = mapped[li]
            graph.tolerence = max(int(3 * lib.sd_insert), max_k)
            graph.min_link = min_link
            graph.make_graph()
            graph.solve_simple_cross_structure_iterative(
                0.25, "link", rebuild=graph.make_graph)
            if graph.contig_tag is not None:
                graph.solve_simple_cross_structure_iterative(
                    0.25, "tag", rebuild=graph.make_graph)
            # gapped variants (solveDBG.cpp extendConsensus:
            # joinUnambiguousNodePairGappedIterative +
            # solveSimpleGappedCrossStructure, pairedDBG.cpp:2517,1641)
            while graph.join_unambiguous_node_pair_gapped():
                graph.make_graph()
            while graph.solve_simple_gapped_cross_structure(0.25, "link"):
                graph.make_graph()

        # base-level erroneous division before scaffolding
        # (solveDBG.cpp:1332-1334)
        if libs:
            graph.lib = libs[0]
            divide_erroneous_node_base_level(graph, libs, mapped,
                                             read_records)

        # consensus scaffolding rounds (extendConsensus scaffolding block,
        # solveDBG.cpp:1338-1380; PREVIOUS_DIVISION_AWARE_MODE active)
        graph.min_overlap = min_overlap_scaf
        for iteration in range(2):
            for li, lib in enumerate(libs):
                graph.lib = lib
                graph.pairs = mapped[li]
                # insert-size re-estimation on current scaffolds
                # (updateAndWriteInsertSize, solveDBG.cpp:1341)
                update_insert_size(graph, mapped[li], lib)
                LOG.info(f"[LIBRARY {li + 1}] AVE_INS = {lib.average_insert}, "
                         f"SD_INS = {lib.sd_insert}")
                for tf in range(MIN_TOL_FACTOR, MAX_TOL_FACTOR + 1):
                    graph.tolerence = int(tf * lib.sd_insert)
                    graph.min_link = 1
                    LOG.counter("TOLERENCE_LEVEL_OF_CONTIG_OVERLAP",
                                graph.tolerence)
                    graph.make_graph()
                    graph.delete_edge_from_different_previous_parent()
                    if iteration == 0:
                        graph.delete_thin_edge(max(min_link,
                                                   graph.estimate_link()))
                    else:
                        graph.delete_thin_edge(min_link)
                    graph.delete_erroneous_edge_iterative()
                    # tag-rate edge cleaning (solveDBG.cpp:1359-1360)
                    graph.delete_erroneous_edge_num_tag_rate_iterative()
                    if iteration > 0:
                        graph.min_link = min_link
                        graph.delete_repeat_edge()
                    graph.detect_repeat(graph.average_coverage)
                    graph.make_scaffold()
            if libs:
                graph.lib = libs[0]
                divide_erroneous_node_base_level(graph, libs, mapped,
                                                 read_records)
        # long-read scaffolding pass (extendConsensus long-read block,
        # solveDBG.cpp:1385-1410: makeGraph -> deleteErroneousEdgeScore(0.125)
        # -> deleteRepeatEdge -> detectRepeat -> makeScaffoldCombine)
        if read_records:
            graph.tolerence = min(avg_long_len,
                                  2 * max_k) if avg_long_len else 2 * max_k
            graph.min_link = min_link
            graph.make_graph_long(read_records)
            graph.delete_erroneous_edge_score(0.125)
            graph.delete_repeat_edge()
            graph.detect_repeat(graph.average_coverage)
            graph.make_scaffold()
            if libs:
                graph.lib = libs[0]
                divide_erroneous_node_base_level(graph, libs, mapped,
                                                 read_records)
    graph.min_overlap = max_k - 1


def write_results(results, out_prefix: str, suffix: str, comp_suffix: str):
    recs = [(r.name, fa.codes_to_seq(r.seq)) for r in results
            if not r.redundant]
    fa.write_fasta(out_prefix + suffix, recs)
    with open(out_prefix + comp_suffix, "w") as f:
        for r in results:
            if not r.redundant:
                f.write(r.component)
    return len(recs)


def _no_scaffold_phasing(args) -> int:
    """-no_scaffold: classify the input contigs directly into the
    *Contig.fa output variants (solveDBG.cpp:628-631) via post-hoc
    containment classification (models.phasing)."""
    from ..models.phasing import classify_phase_blocks, write_phase_outputs
    from ..models.scaffold import ResultSeq

    names, seqs, covs, read_len, max_k = load_contigs(args.c)
    results = [ResultSeq(seq=s, name=n, component="")
               for n, s in zip(names, seqs)]
    graph_avg = float(np.average(covs, weights=[len(s) for s in seqs])
                      if len(seqs) else 0.0)
    suffixes = ("_primaryBubbleContig.fa", "_secondaryBubbleContig.fa",
                "_nonBubbleHeteroContig.fa", "_nonBubbleOtherContig.fa",
                "_bubbleContigRelation.tsv")
    bubbles = []
    for path in args.b:
        if not os.path.exists(path):
            raise IOError_(f"cannot open file: {path}")
        for n, s in fa.iter_fasta(path):
            bubbles.append((fa.parse_cov(n), fa.seq_to_codes(s)))
    pairs, hetero_ids, other_ids, blocks = classify_phase_blocks(
        results, bubbles, graph_avg, hetero_coverage=0.0)
    write_phase_outputs(args.o, pairs, hetero_ids, other_ids, blocks,
                        read_len, max_k, suffixes=suffixes)
    with open(args.o + "_phasedScaffoldComponent.bed", "w") as f:
        for r in results:
            f.write(r.component)
    LOG.info("solve_DBG completed!")
    LOG.report_memory()
    return 0


def run_phasing(args) -> int:
    """Default (phasing) flow — graph-tracked haplotype division
    (solveDBG.cpp:266-637): contig-level bubble pairing feeds node-level
    opposite-bubble tracking; 4 outer rounds of cross resolution
    (LINK/TAG/SCORE, per-library + AllLibraries, overlap + gapped),
    bubble-aware phase scaffolding, and bubble-based node division; then
    secondary-bubble removal, a consensus extension, secondary recovery,
    and paired primary/secondary outputs (pairedDBG.cpp:2296-2389)."""
    from ..models import bubble as bb
    from ..models import hetero
    from ..models.divide import divide_erroneous_node
    from ..models.scaffold import (CROSS_LINK_RATE_THRESHOLD,
                                   CROSS_SCORE_RATE_THRESHOLD)

    if args.no_scaffold:
        return _no_scaffold_phasing(args)

    (graph, libs, mapped, read_records, avg_long_len, read_len, max_k,
     n_normal) = _setup_graph(
        args.c, getattr(args, "libspecs", []), args.o, args.l,
        tuple(args.s), tuple(args.p) + tuple(args.ont),
        tuple(args.x), tuple(args.X), bubble_paths=tuple(args.b))
    min_link = args.l
    min_link_phase = args.k
    sources = list(zip(libs, mapped))
    tag_mode = "tag" if graph.contig_tag is not None else "link"

    strict = getattr(args, "strict_phase", False)
    if strict:
        # strict reference parity: DBG_OVERLAP edge gate + heteroCoverage
        # preset (solveDBG.cpp:802-807 — calculateHeteroCoverage never
        # runs in solve_DBG because the preset is > 0); the average uses
        # calculateAverageCoverageExcludingOutlier at the median length
        from .merge_cmd import average_coverage_excluding_outlier
        graph.strict_dbg_overlap = True
        lens = [len(c) for c in graph.contig]
        avg = average_coverage_excluding_outlier(lens, graph.coverage)
        graph.average_coverage = avg
        graph.hetero_coverage = avg / 2.0
        LOG.counter("PRESET_HETERO_COVERAGE", graph.hetero_coverage)
        # the reference's flow-wide minOverlap is minOverlapForScaffolding
        # (-v, solveDBG.cpp:760), raised to contigMaxK-1 only around the
        # long-read sections (:474-483); the exact-equality gate therefore
        # tests overlap == -v, which dbg-join overlaps (maxK-1) fail —
        # that IS why the reference finds zero diamonds on its own
        # assemble outputs
        graph.min_overlap = args.v

    def rebuild_pe():
        graph.make_graph()

    def rebuild_long():
        graph.make_graph_long(read_records)

    # initial bubble information (solveDBG.cpp:266-281)
    hetero.extract_dbg_bubble_information(graph, max_k)
    bb.set_opposite_bubble_contig_id_by_end_match(graph, n_normal)
    hetero.set_opposite_bubble_contig_id_overlapped(graph)
    bb.set_bubble_junction_contig_id_overlapped(graph)
    join_unambiguous_overlaps(graph)

    for outer in range(4):
        # --- overlap-mode cross solving (solveDBG.cpp:283-346)
        for li, lib in enumerate(libs):
            graph.lib, graph.pairs = lib, mapped[li]
            graph.tolerence = int(MAX_TOL_FACTOR * lib.sd_insert)
            graph.min_link = min_link_phase
            join_unambiguous_overlaps(graph)
            rebuild_pe()
            graph.solve_simple_cross_structure_iterative(
                CROSS_LINK_RATE_THRESHOLD, "link", rebuild=rebuild_pe)
            graph.min_link = min_link
            graph.solve_simple_cross_structure_iterative(
                CROSS_LINK_RATE_THRESHOLD, "link", rebuild=rebuild_pe)
        if read_records:
            graph.min_link = min_link_phase
            join_unambiguous_overlaps(graph)
            rebuild_long()
            graph.solve_simple_cross_structure_iterative(
                CROSS_SCORE_RATE_THRESHOLD, "score", rebuild=rebuild_long)
            graph.min_link = min_link
            graph.solve_simple_cross_structure_iterative(
                CROSS_LINK_RATE_THRESHOLD, tag_mode, rebuild=rebuild_long)
        if libs:
            graph.lib, graph.pairs = libs[-1], mapped[-1]
            graph.min_link = min_link_phase
            graph.solve_cross_all_libraries_iterative("link", sources,
                                                      read_records)
            graph.min_link = min_link
            graph.solve_cross_all_libraries_iterative(tag_mode, sources,
                                                      read_records)

        # --- gapped cross solving (solveDBG.cpp:349-417)
        for iteration in range(2):
            for li, lib in enumerate(libs):
                graph.lib, graph.pairs = lib, mapped[li]
                graph.min_link = (min_link_phase if iteration == 0
                                  else min_link)
                for tf in range(MIN_TOL_FACTOR, MAX_TOL_FACTOR + 1):
                    graph.tolerence = int(tf * min(
                        lib.sd_insert, 0.1 * lib.average_insert))
                    graph.trim_sparse_end()
                    rebuild_pe()
                    if iteration > 0:
                        while graph.join_unambiguous_node_pair_gapped():
                            rebuild_pe()
                    while graph.solve_simple_gapped_cross_structure(
                            CROSS_LINK_RATE_THRESHOLD, "link"):
                        rebuild_pe()
                    if graph.contig_tag is not None:
                        while graph.solve_simple_gapped_cross_structure(
                                CROSS_LINK_RATE_THRESHOLD, "tag"):
                            rebuild_pe()
            if read_records:
                graph.tolerence = 2 * max_k
                graph.min_link = (min_link_phase if iteration == 0
                                  else min_link)
                graph.trim_sparse_end()
                rebuild_long()
                while graph.solve_simple_gapped_cross_structure(
                        CROSS_SCORE_RATE_THRESHOLD, "score"):
                    rebuild_long()
            if libs:
                graph.lib, graph.pairs = libs[-1], mapped[-1]
                if iteration > 0:
                    graph.min_link = min_link
                    graph.join_unambiguous_node_pair_gapped_iterative_all_libraries(
                        sources, read_records)
                graph.trim_sparse_end()
                graph.solve_cross_all_libraries_iterative(
                    "link", sources, read_records, gapped=True)

        # --- bubble divisions (solveDBG.cpp:419-426)
        graph.trim_sparse_end()
        bb.divide_node_using_bubble_contig_pair(graph)
        if libs:
            divide_erroneous_node(graph, libs, mapped, min_link)
        bb.divide_node_based_on_bubbles_iterative(graph, True)
        bb.divide_bubble_contig_in_non_hetero_node(graph)
        bb.divide_bubble_junction_node(graph, False)

        # --- bubble-aware phase scaffolding (solveDBG.cpp:428-478)
        graph.min_overlap = args.v
        for iteration in range(2):
            for li, lib in enumerate(libs):
                graph.lib, graph.pairs = lib, mapped[li]
                link_threshold = (min_link if iteration == 0
                                  else max(min_link, graph.estimate_link()))
                for tf in range(MIN_TOL_FACTOR, MAX_TOL_FACTOR + 1):
                    graph.tolerence = int(tf * min(
                        lib.sd_insert, 0.1 * lib.average_insert))
                    graph.trim_sparse_end()
                    graph.min_link = link_threshold
                    rebuild_pe()
                    graph.delete_repeat_edge()
                    graph.detect_repeat(graph.hetero_coverage)
                    graph.make_scaffold()
                    while graph.join_unambiguous_node_pair_gapped():
                        rebuild_pe()
                    graph.min_link = min_link
                    while graph.solve_simple_gapped_cross_structure(
                            CROSS_LINK_RATE_THRESHOLD, "link"):
                        rebuild_pe()
                    graph.min_link = link_threshold
                    rebuild_pe()
                    graph.delete_erroneous_edge_num_tag_rate_iterative()
                    bb.delete_different_bubble_edge_iterative(graph)
                    graph.delete_repeat_edge()
                    graph.detect_repeat(graph.hetero_coverage)
                    graph.make_scaffold()
            if libs:
                graph.lib, graph.pairs = libs[0], mapped[0]
                if outer < 2:
                    divide_erroneous_node(graph, libs, mapped, min_link,
                                          mode="gap", max_gap_size=max_k)
                else:
                    divide_erroneous_node(graph, libs, mapped, min_link)
        graph.min_overlap = max_k - 1

        # --- long-read phase scaffolding (solveDBG.cpp:537-586, condensed)
        if read_records:
            graph.min_overlap = args.v
            bb.divide_node_using_bubble_contig_pair(graph)
            graph.tolerence = 2 * max_k
            graph.min_link = min_link
            rebuild_long()
            graph.delete_erroneous_edge_iterative()
            graph.delete_repeat_edge()
            graph.detect_repeat(graph.hetero_coverage)
            graph.make_scaffold()
            rebuild_long()
            graph.delete_erroneous_edge_num_tag_rate_iterative()
            bb.delete_different_bubble_edge_iterative(graph)
            graph.delete_repeat_edge()
            graph.detect_repeat(graph.hetero_coverage)
            graph.make_scaffold()
            graph.min_overlap = max_k - 1

        # --- end-of-round divisions (solveDBG.cpp:588-599)
        graph.trim_sparse_end()
        bb.divide_node_based_on_bubbles_iterative(graph, True)
        bb.divide_bubble_junction_node(graph, True)
        if libs:
            divide_erroneous_node(graph, libs, mapped, min_link)
        bb.divide_node_based_on_bubbles_iterative(graph, True)
        if outer < 2:
            join_unambiguous_overlaps(graph)
            graph.divide_gapped_node((outer + 1) * max_k)

    # --- final phase separation (solveDBG.cpp:601-637)
    bb.divide_bubble_contig_in_non_hetero_node(graph)
    if libs:
        graph.lib, graph.pairs = libs[-1], mapped[-1]
        graph.min_link = min_link
        rebuild_pe()
    bb.adjust_opposite_bubble_node_id_direction(graph)
    snapshot = bb.copy_all_nodes(graph)
    bb.delete_secondary_bubble_node_and_edge(graph)
    graph.make_scaffold()
    extend_consensus(graph, libs, mapped, read_records, avg_long_len,
                     max_k, min_link, args.v)
    graph.tolerence = (int(MAX_TOL_FACTOR * libs[-1].sd_insert) if libs
                       else max_k)
    results = graph.load_result_seq(max_k, read_len, max_k, False)
    fa.write_fasta(args.o + "_preliminaryConsensusScaffold.fa",
                   [(r.name, fa.codes_to_seq(r.seq)) for r in results])

    bb.remake_graph_recovering_secondary_bubble(graph, snapshot)
    if libs:
        rebuild_pe()
    bb.divide_node_based_on_bubbles_iterative(graph, False)
    if libs:
        rebuild_pe()
    # recompute pairing/states on the recovered graph, THEN re-sign the
    # opposite ids by end-contig strand (adjust last — it refines the
    # state pass's unsigned ids, solveDBG.cpp:622-626)
    bb.set_opposite_bubble_node_id_and_state_for_each_node(graph)
    bb.adjust_opposite_bubble_node_id_direction(graph)
    results = graph.load_result_seq(max_k, read_len, max_k,
                                    args.trim_overlap)
    if args.reduce_redundancy:
        mark_redundant_result_seq(results)
    suffixes = ("_primaryBubble.fa", "_secondaryBubble.fa",
                "_nonBubbleHetero.fa", "_nonBubbleOther.fa",
                "_bubbleRelation.tsv")
    # graph-tracked pairing first (outputResultSeqWithBubble semantics),
    # then a post-hoc containment-alignment fallback pairs leftover
    # haplotigs that never acquired graph links (HeteroMapper mergeBubble
    # analogue — strictly additive over the reference's classification).
    # -strict_phase disables the fallback: classification is then EXACTLY
    # the reference's pair-flag/secondary-state partition
    # (pairedDBG.cpp:2327-2389)
    paired, hetero_recs, _other, leftovers = bb.classify_result_nodes(
        graph, results)
    from ..models.phasing import (PhaseBlock, classify_phase_blocks,
                                  write_phase_outputs)
    if strict:
        # unpaired non-secondary records ARE non_bubble_other
        # (pairedDBG.cpp:2369-2386 else-branch); no alignment fallback
        pairs, hetero_ids, other_ids, blocks = [], [], [], []
        for r, cov in leftovers:
            blocks.append(PhaseBlock(seq=r.seq, coverage=cov, source=-2))
            other_ids.append(len(blocks) - 1)
    else:
        leftover_results = [r for r, _cov in leftovers]
        pairs, hetero_ids, other_ids, blocks = classify_phase_blocks(
            leftover_results, [], graph.average_coverage,
            hetero_coverage=graph.hetero_coverage)
    for r, cov in hetero_recs:
        blocks.append(PhaseBlock(seq=r.seq, coverage=cov, source=-2,
                                 secondary=True))
        hetero_ids.append(len(blocks) - 1)
    for r, cov, alt_seq, alt_cov in reversed(paired):
        blocks.append(PhaseBlock(seq=r.seq, coverage=cov, source=-2))
        blocks.append(PhaseBlock(seq=alt_seq, coverage=alt_cov, source=-2,
                                 secondary=True))
        pairs.insert(0, (len(blocks) - 2, len(blocks) - 1))
    write_phase_outputs(args.o, pairs, hetero_ids, other_ids, blocks,
                        read_len, max_k, suffixes=suffixes)
    with open(args.o + "_phasedScaffoldComponent.bed", "w") as f:
        for r in results:
            if not r.redundant:
                f.write(r.component)
    LOG.counter("NUM_OUTPUT_SEQ", 2 * len(pairs) + len(hetero_ids)
                + len(other_ids))
    LOG.info("solve_DBG completed!")
    LOG.report_memory()
    return 0


def run(args) -> int:
    if not args.c:
        raise ArgError("solve_dbg: no contig file given (-c)")
    if args.unphase:
        results, _g = run_unphase(
            args.c, getattr(args, "libspecs", []), args.o,
            min_link=args.l, min_overlap_scaf=args.v,
            seed_lengths=tuple(args.s),
            reduce_redundancy=args.reduce_redundancy,
            trim_overlap=args.trim_overlap,
            long_read_paths=tuple(args.p) + tuple(args.ont),
            tag_x_paths=tuple(args.x), tag_xx_paths=tuple(args.X))
        n = write_results(results, args.o, "_consensusScaffold.fa",
                          "_consensusScaffoldComponent.bed")
        LOG.counter("NUM_OUTPUT_SEQ", n)
        LOG.info("solve_DBG completed!")
        LOG.report_memory()
        return 0
    if args.divide_only:
        from .divide_impl import run_divide_only
        return run_divide_only(args)
    if args.combine:
        from .combine_impl import run_combine
        return run_combine(args)
    return run_phasing(args)
