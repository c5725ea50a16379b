"""Combinatorial gap closing + redundancy removal (Perl pipeline rebuild).

Re-design of the reference's scripts/ pipeline (933 LoC Perl + minimap2,
orchestrated from iterate.cpp:517-549 and combine.cpp:208-251):
- fasta_around_gap.pl:   extract L/R flanks of every gap (short contigs
                         count as gap-like)
- minimap2 -x asm10:     models.longread with the asm10 preset
- paf_max_match_unique:  per-query unique best-match filter
- paf_filter_qcov:       identity + query-coverage filter
- paf_filter_flanking_pair: same-target/strand L-R pair distance check
- get_flanked_region_info:  fill-region extraction from the complement
- reduce_filled_info:    longest-flank-first non-overlap reduction
- close_gap.pl:          patch the base assembly
- remove_redundant_seq.pl: drop sequences contained in longer ones

Port copy of platanus_b_tpu/models/combinatorial.py: the reference's text,
its imports resolving to the port's long-read aligner (models/longread.py)
and log. No adaptation: the module is host code over LongReadAligner.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils.log import LOG
from .longread import Alignment, LongReadAligner

FLANK_LENGTHS = (500, 1000, 5000, 10000, 20000, 40000, 80000, 160000)
MAX_DIST = 100000
MIN_IDT = 0.90
MIN_QCOV = 0.25
N_ITERATION = 2


def _gap_runs(seq: np.ndarray, flank_len: int):
    """Gap-like runs: Ns plus contig runs shorter than flank_len
    (fasta_around_gap.pl lowercasing trick)."""
    gaplike = seq == 4
    isb = ~gaplike
    d = np.diff(isb.astype(np.int8))
    starts = ([0] if isb[0] else []) + list(np.nonzero(d == 1)[0] + 1)
    ends = list(np.nonzero(d == -1)[0] + 1) + ([len(seq)] if isb[-1] else [])
    for st, ed in zip(starts, ends):
        if ed - st < flank_len:
            gaplike[st:ed] = True
    d = np.diff(gaplike.astype(np.int8))
    gstarts = ([0] if gaplike[0] else []) + list(np.nonzero(d == 1)[0] + 1)
    gends = list(np.nonzero(d == -1)[0] + 1) + ([len(seq)] if gaplike[-1] else [])
    return gaplike, list(zip(gstarts, gends))


def extract_gap_flanks(seqs, names, flank_len: int):
    """(flank name, flank codes) pairs; names encode name;start;end;len;L/R."""
    out = []
    for name, seq in zip(names, seqs):
        gaplike, runs = _gap_runs(seq, flank_len)
        for gs, ge in runs:
            if gs - flank_len < 0 or ge + flank_len > len(seq):
                continue
            left = seq[gs - flank_len: gs]
            right = seq[ge: ge + flank_len]
            if gaplike[gs - flank_len: gs].any() or gaplike[ge: ge + flank_len].any():
                continue
            out.append((f"{name};{gs};{ge};{flank_len};L", left))
            out.append((f"{name};{gs};{ge};{flank_len};R", right))
    return out


def max_match_unique(alignments: list[Alignment]) -> list[Alignment]:
    """paf_max_match_unique.pl: the single best-match alignment per query,
    dropped when tied."""
    by_q: dict[str, list[Alignment]] = {}
    for a in alignments:
        by_q.setdefault(a.q_name, []).append(a)
    out = []
    for q, alns in by_q.items():
        alns.sort(key=lambda a: -a.matches)
        if len(alns) == 1 or alns[0].matches > alns[1].matches:
            out.append(alns[0])
    return out


def filter_qcov(alignments, min_idt: float, min_qcov: float):
    """paf_filter_qcov.pl: identity (matches/block) and query coverage."""
    return [a for a in alignments
            if a.matches / max(a.block_len, 1) >= min_idt
            and (a.q_end - a.q_start) / max(a.q_len, 1) >= min_qcov]


@dataclass
class FillInfo:
    name: str
    gap_start: int
    gap_end: int
    inner_start: int     # replaced region on the base sequence
    inner_end: int
    fill: np.ndarray     # replacement codes from the complement


def flanking_pairs_to_fills(alignments, comp_seqs, comp_names,
                            max_dist: int = MAX_DIST) -> list[FillInfo]:
    """paf_filter_flanking_pair.pl + get_flanked_region_info.pl."""
    comp = {n: s for n, s in zip(comp_names, comp_seqs)}
    pairs: dict[str, list] = {}
    for a in alignments:
        parts = a.q_name.rsplit(";", 4)
        if len(parts) != 5 or parts[4] not in ("L", "R"):
            continue
        gap_id = ";".join(parts[:4])
        ent = pairs.setdefault(gap_id, [None, None])
        ent[1 if parts[4] == "R" else 0] = a
    fills = []
    for gap_id, (L, R) in pairs.items():
        if L is None or R is None or L.t_name != R.t_name or L.strand != R.strand:
            continue
        if L.strand == "+":
            dist = (R.t_start - R.q_start) - (L.t_end + (L.q_len - L.q_end))
        else:
            dist = (L.t_start - (L.q_len - L.q_end)) - (R.t_end + R.q_start)
        if abs(dist) > max_dist:
            continue
        name, gs, ge, _fl = gap_id.rsplit(";", 3)
        gs, ge = int(gs), int(ge)
        inner_start = gs - (L.q_len - L.q_end)
        inner_end = ge + R.q_start
        if L.strand == "+":
            a_l, a_r = L.t_end, R.t_start
            if a_r - a_l < 0:
                inner_start = gs - (L.q_len - L.q_start)
                inner_end = ge + R.q_end
                a_l, a_r = L.t_start, R.t_end
            if a_r - a_l < 0:
                continue
            fill = comp[L.t_name][a_l: a_r]
        else:
            a_l, a_r = R.t_end, L.t_start
            if a_r - a_l < 0:
                inner_start = gs - (L.q_len - L.q_start)
                inner_end = ge + R.q_end
                a_l, a_r = R.t_start, L.t_end
            if a_r - a_l < 0:
                continue
            seg = comp[L.t_name][a_l: a_r]
            fill = seg[::-1].copy()
            m = fill < 4
            fill[m] = 3 - fill[m]
        if (fill == 4).any():
            continue  # reference keeps only N-free fills (iterate.cpp:68)
        fills.append(FillInfo(name, gs, ge, inner_start, inner_end, fill))
    return fills


def reduce_and_apply_fills(seqs, names, fills_per_flank: list[list[FillInfo]]):
    """reduce_filled_info.pl + close_gap.pl: longest-flank-first
    non-overlapping fills applied to the base sequences."""
    flags = {n: np.zeros(len(s), dtype=bool) for n, s in zip(names, seqs)}
    chosen: list[FillInfo] = []
    for fill_list in fills_per_flank:  # caller passes longest flank first
        for fi in fill_list:
            fl = flags.get(fi.name)
            if fl is None or fi.inner_end > len(fl) or fi.inner_start < 0:
                continue
            if fl[fi.gap_start: fi.gap_end].any():
                continue
            fl[fi.gap_start: fi.gap_end] = True
            chosen.append(fi)
    out = {n: [s, np.zeros(len(s), dtype=bool)] for n, s in zip(names, seqs)}
    # apply in reverse coordinate order per sequence (close_gap.pl tac)
    for fi in sorted(chosen, key=lambda f: (f.name, -f.inner_start)):
        s, applied = out[fi.name]
        if fi.inner_end > len(s) or applied[fi.inner_start: fi.inner_end].any():
            continue
        new = np.concatenate([s[: fi.inner_start], fi.fill, s[fi.inner_end:]])
        na = np.concatenate([applied[: fi.inner_start],
                             np.ones(len(fi.fill), dtype=bool),
                             applied[fi.inner_end:]])
        out[fi.name] = [new, na]
    return [out[n][0] for n in names], len(chosen)


def combinatorial_gap_close(base_seqs, base_names, comp_seqs, comp_names,
                            flank_lengths=FLANK_LENGTHS, min_idt=MIN_IDT,
                            min_qcov=MIN_QCOV, max_dist=MAX_DIST,
                            n_iteration=N_ITERATION):
    """combinatorial_gap_close.pl main loop."""
    seqs = [s.copy() for s in base_seqs]
    aligner = LongReadAligner(comp_seqs, comp_names, "asm10")
    total = 0
    for it in range(n_iteration):
        fills_per_flank = []
        for fl in sorted(flank_lengths, reverse=True):
            flanks = extract_gap_flanks(seqs, base_names, fl)
            if not flanks:
                fills_per_flank.append([])
                continue
            alns = aligner.align_batch([s for _n, s in flanks],
                                       [n for n, _s in flanks])
            alns = max_match_unique(alns)
            alns = filter_qcov(alns, min_idt, min_qcov)
            fills_per_flank.append(
                flanking_pairs_to_fills(alns, comp_seqs, comp_names, max_dist))
        seqs, n = reduce_and_apply_fills(seqs, base_names, fills_per_flank)
        total += n
        LOG.counter(f"COMBINATORIAL_FILLS_ITER{it + 1}", n)
        if n == 0:
            break
    return seqs, total


def remove_redundant(seqs, names, min_qcov: float = 0.99,
                     min_idt: float
                     = 0.97) -> list[bool]:
    """remove_redundant_seq.pl: True where a sequence is contained in a
    longer (or equal, later-named) one at near-full coverage."""
    if len(seqs) < 2:
        return [False] * len(seqs)
    aligner = LongReadAligner(seqs, names, "asm10")
    alns = aligner.align_batch(seqs, names)
    lens = {n: len(s) for n, s in zip(names, seqs)}
    redundant = {n: False for n in names}
    # accumulate per (query, target) coverage from all chains
    cov: dict[tuple[str, str], int] = {}
    for a in alns:
        if a.q_name == a.t_name:
            continue
        if a.matches / max(a.block_len, 1) < min_idt:
            continue
        key = (a.q_name, a.t_name)
        cov[key] = cov.get(key, 0) + (a.q_end - a.q_start)
    for (q, t), c in cov.items():
        if c / max(lens[q], 1) < min_qcov:
            continue
        if lens[q] < lens[t] or (lens[q] == lens[t] and q > t):
            redundant[q] = True
    return [redundant[n] for n in names]
