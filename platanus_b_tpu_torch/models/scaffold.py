"""Scaffold result records (counterpart of the first pieces of
platanus_b_tpu/models/scaffold.py).

Only what `gap_close -reduce_redundancy` needs is here for now:
``ResultSeq`` (scaffold.py:87) and ``mark_redundant_result_seq``
(scaffold.py:1578), lifted unchanged. The scaffold graph arrives with the
solve_dbg port.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class ResultSeq:
    seq: np.ndarray
    name: str
    component: str
    redundant: bool = False
    node_index: int = -1   # source node (for bubble pairing outputs)


def mark_redundant_result_seq(results: list[ResultSeq],
                              contig_max_k: int = 32) -> None:
    """markRedundantResultSeq (pairedDBG.cpp:6266-6340): flag sequences
    exactly contained (either strand) in a longer sequence — the reference
    is exact-substring matching accelerated by a shared-prefix index
    (prefixLength = contigMaxK capped to the shortest sequence;
    std::search at each prefix hit), reproduced here.
    """
    live = [i for i, r in enumerate(results) if len(r.seq)]
    if not live:
        return
    prefix_len = min(contig_max_k, min(len(results[i].seq) for i in live))
    strs = ["".join("ACGTN"[b] for b in r.seq) for r in results]
    prefix_to_idx: dict[str, list[int]] = {}
    for i in live:
        prefix_to_idx.setdefault(strs[i][:prefix_len], []).append(i)

    comp = str.maketrans("ACGTN", "TGCAN")
    for i in live:
        for strand in (0, 1):
            target = strs[i] if strand == 0 else \
                strs[i].translate(comp)[::-1]
            for base in range(len(target) - prefix_len + 1):
                for j in prefix_to_idx.get(target[base: base + prefix_len],
                                           ()):
                    if j == i or results[j].redundant:
                        continue
                    sj = strs[j]
                    if not (len(target) > len(sj)
                            or (len(target) == len(sj) and i < j)):
                        continue
                    if (len(target) - base >= len(sj)
                            and target[base: base + len(sj)] == sj):
                        results[j].redundant = True
