"""Haplotype phase-block classification (solve_DBG default flow subset).

Re-design of the reference's bubble-aware phasing output
(PairedDBG::outputResultSeqWithBubble, pairedDBG.cpp:2296-2394): result
sequences are partitioned into primary/secondary bubble pairs, non-bubble
hetero sequences, and non-bubble other sequences.

The reference tracks opposite-bubble node IDs through the whole graph flow
(setOppositeBubbleContigID*, pairedDBG.cpp:2613-2708). This rebuild pairs
haplotypes *post hoc* by alignment, which is equivalent for the isolated
genomes Platanus_B targets: a secondary haplotype block is a sequence that
(a) sits below the hetero coverage threshold (1.75 x heteroCoverage,
pairedDBG.cpp:63) and (b) aligns near-fully, with high identity, onto a
distinct higher-coverage sequence. Input bubble sequences (-b, the crushed
bubbles from assemble) are always secondary candidates, mirroring
HeteroMapper bubble mapping (mapper.cpp:215-313).

Port copy of platanus_b_tpu/models/phasing.py: the reference's text, its
relative imports resolving to the port's modules (longread, log) and to
the JAX package's numpy-only ``io``. No other change.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..utils.log import LOG

# pairedDBG.cpp:63 — hetero if coverage < 1.75 x heteroCoverage
HETERO_COVERAGE_THRESHOLD_FACTOR = 1.75
# containment thresholds for haplotype pairing (same grade the reference
# uses for redundancy marking / bubble alignment, pairedDBG.cpp:6266-6340)
MIN_PAIR_IDENTITY = 0.8
MIN_PAIR_QCOV = 0.8


@dataclass
class PhaseBlock:
    seq: np.ndarray
    coverage: float
    source: int          # index into the result list, or -1 for -b bubbles
    is_bubble_input: bool = False
    partner: int | None = None   # index into the block list
    secondary: bool = False


def _align_containment(blocks: list[PhaseBlock], query_ids: list[int],
                       target_ids: list[int]):
    """Best containment alignment of each query block onto target blocks.

    Returns {query block id: (target block id, identity, qcov)}."""
    from .longread import LongReadAligner

    targets = [blocks[t].seq for t in target_ids]
    tnames = [str(t) for t in target_ids]
    queries = [blocks[q].seq for q in query_ids]
    qnames = [str(q) for q in query_ids]
    if not targets or not queries:
        return {}
    aligner = LongReadAligner(targets, tnames, "asm10")
    alns = aligner.align_batch(queries, qnames)
    best: dict[int, tuple[int, float, float]] = {}
    for a in alns:
        qid, tid = int(a.q_name), int(a.t_name)
        if qid == tid:
            continue
        qcov = (a.q_end - a.q_start) / max(a.q_len, 1)
        if a.identity < MIN_PAIR_IDENTITY or qcov < MIN_PAIR_QCOV:
            continue
        cur = best.get(qid)
        if cur is None or a.score > cur[3]:
            best[qid] = (tid, a.identity, qcov, a.score)
    return {q: v[:3] for q, v in best.items()}


def classify_phase_blocks(results, bubbles, average_coverage: float,
                          hetero_coverage: float = 0.0):
    """Partition scaffolds (+ input bubbles) into phase classes.

    results: list of ResultSeq (scaffold.load_result_seq output) with
             coverage parsed from the name; redundant ones are skipped.
    bubbles: list of (coverage, codes) for -b input bubble sequences.
    Returns (pairs, hetero_ids, other_ids, blocks) where pairs is a list of
    (primary block id, secondary block id).
    """
    from ..io import fasta as fa

    blocks: list[PhaseBlock] = []
    for i, r in enumerate(results):
        if r.redundant or len(r.seq) == 0:
            continue
        blocks.append(PhaseBlock(seq=r.seq, coverage=fa.parse_cov(r.name),
                                 source=i))
    for cov, codes in bubbles:
        blocks.append(PhaseBlock(seq=codes, coverage=cov, source=-1,
                                 is_bubble_input=True))

    if hetero_coverage <= 0:
        bubble_covs = [b.coverage for b in blocks if b.is_bubble_input]
        hetero_coverage = (float(np.mean(bubble_covs)) if bubble_covs
                           else average_coverage / 2.0)
    hetero_cut = HETERO_COVERAGE_THRESHOLD_FACTOR * hetero_coverage
    LOG.counter("HETERO_COVERAGE", hetero_coverage)

    # secondary candidates: all -b bubbles + hetero-coverage scaffolds
    cand = [bi for bi, b in enumerate(blocks)
            if b.is_bubble_input or b.coverage < hetero_cut]
    targets = [bi for bi, b in enumerate(blocks) if not b.is_bubble_input]
    best = _align_containment(blocks, cand, targets)

    # greedy pairing, strongest containment first; one partner per block
    pairs: list[tuple[int, int]] = []
    order = sorted(best, key=lambda q: -best[q][2])
    for q in order:
        t = best[q][0]
        if blocks[q].partner is not None or blocks[t].partner is not None:
            continue
        # the secondary is the lower-coverage side unless q is a -b bubble
        if not blocks[q].is_bubble_input and blocks[q].coverage > blocks[t].coverage:
            q, t = t, q
        blocks[q].partner, blocks[t].partner = t, q
        blocks[q].secondary = True
        pairs.append((t, q))

    hetero_ids = [bi for bi, b in enumerate(blocks)
                  if b.partner is None and not b.is_bubble_input
                  and b.coverage < hetero_cut]
    other_ids = [bi for bi, b in enumerate(blocks)
                 if b.partner is None and not b.is_bubble_input
                 and b.coverage >= hetero_cut]
    # unpaired input bubbles stay hetero (they are known variant sequence)
    hetero_ids += [bi for bi, b in enumerate(blocks)
                   if b.partner is None and b.is_bubble_input]
    LOG.counter("NUM_BUBBLE_PAIRS", len(pairs))
    LOG.counter("NUM_NON_BUBBLE_HETERO", len(hetero_ids))
    LOG.counter("NUM_NON_BUBBLE_OTHER", len(other_ids))
    return pairs, hetero_ids, other_ids, blocks


def write_phase_outputs(out_prefix: str, pairs, hetero_ids, other_ids,
                        blocks, read_length: int, max_k: int,
                        suffixes=("_primaryBubble.fa", "_secondaryBubble.fa",
                                  "_nonBubbleHetero.fa", "_nonBubbleOther.fa",
                                  "_bubbleRelation.tsv")) -> None:
    """outputResultSeqWithBubble (pairedDBG.cpp:2296-2394) file layout."""
    from ..io import fasta as fa

    def header(tag: str, n: int, b: PhaseBlock) -> str:
        return (f"{tag}{n}_len{len(b.seq)}_cov{int(b.coverage + 0.5)}"
                f"_read{read_length}_maxK{max_k}")

    num = 0
    prim_recs, sec_recs, rel_lines = [], [], []
    for p, s in pairs:
        num += 1
        hp = header("primary_bubble", num, blocks[p])
        hs = header("secondary_bubble", num, blocks[s])
        prim_recs.append((hp, fa.codes_to_seq(blocks[p].seq)))
        sec_recs.append((hs, fa.codes_to_seq(blocks[s].seq)))
        rel_lines.append(f"{hp}\t{hs}\n")
    het_recs, oth_recs = [], []
    for bi in hetero_ids:
        num += 1
        het_recs.append((header("non_bubble_hetero", num, blocks[bi]),
                         fa.codes_to_seq(blocks[bi].seq)))
    for bi in other_ids:
        num += 1
        oth_recs.append((header("non_bubble_other", num, blocks[bi]),
                         fa.codes_to_seq(blocks[bi].seq)))
    fa.write_fasta(out_prefix + suffixes[0], prim_recs)
    fa.write_fasta(out_prefix + suffixes[1], sec_recs)
    fa.write_fasta(out_prefix + suffixes[2], het_recs)
    fa.write_fasta(out_prefix + suffixes[3], oth_recs)
    with open(out_prefix + suffixes[4], "w") as f:
        f.writelines(rel_lines)
