#!/usr/bin/env python3
"""lex_search.cu variants against each other, in turns, on one CUDA card.

    git show <commit>:platanus_b_tpu_torch/csrc/lex_search.cu \\
        > platanus_b_tpu_torch/build/lex_search_old.cu
    python3 lex_search_in_turns.py [platanus_b_tpu_torch/build/lex_search_old.cu]

Builds platanus_b_tpu_torch/csrc/lex_search.cu with the port's nvcc flags
once as it stands and once for each VARIANTS entry (-D LEX_TREE_BYTES,
the shared-memory tree's budget a block, and -D LEX_QUERIES, the queries
a thread), and the given earlier source if any, all at once, into
platanus_b_tpu_torch/build/in_turns/. Runs every build on the main path's
inputs: the adjacency lookups of graphs counted from chip_smoke phase 3's
1 Mbp reads at k 63 (two lanes) and k 32 (one lane), keeping the k-mers
seen twice or more (the real queries come in nearly sorted runs, which
random ones do not), and a lookup_range at phase 5's polish shape
(SYNTHETIC_RANGE) made on the card from a seed: sorted random keys in
duplicate runs, half the queries drawn from the table, in random order,
as reads give them. Requires every build's outputs to equal the plain
version's, and
times them with chip_smoke.cuda_ms (20 launches) in the order of the
builds, then in reverse. Prints one JSON line a shape (each build's two
times), then the card's name and power limit. Exits non-zero without a
card, on a failed build or on unequal results.
"""

from __future__ import annotations

import json
import os
import sys

import chip_smoke as cs
import in_turns as it

# (name, -D flags)
VARIANTS = [("tree0_q1", ["-DLEX_TREE_BYTES=0", "-DLEX_QUERIES=1"]),
            ("tree0_q4", ["-DLEX_TREE_BYTES=0", "-DLEX_QUERIES=4"]),
            ("tree4k_q1", ["-DLEX_TREE_BYTES=4096", "-DLEX_QUERIES=1"]),
            ("tree4k_q2", ["-DLEX_TREE_BYTES=4096", "-DLEX_QUERIES=2"]),
            ("tree4k_q4", ["-DLEX_TREE_BYTES=4096", "-DLEX_QUERIES=4"]),
            ("tree32k_q1", ["-DLEX_TREE_BYTES=32768", "-DLEX_QUERIES=1"]),
            ("tree32k_q4", ["-DLEX_TREE_BYTES=32768", "-DLEX_QUERIES=4"])]
ADJACENCY_K = {"adjacency_k63": 63, "adjacency_k32_l1": 32}
# live rows, capacity, lanes, queries
SYNTHETIC_RANGE = (1_020_169, 1 << 20, 1, 2_402_400)


def adjacency_lookups(dev, reads_fa: str):
    """{name: (table, queries)} of the largest lookup of each graph's
    adjacency (ADJACENCY_K)."""
    from platanus_b_tpu_torch.models import dbg
    from platanus_b_tpu_torch.models.assemble_core import count_reads_device
    staged = cs.load_main_reads(reads_fa, dev)
    out = {}
    for name, k in ADJACENCY_K.items():
        keys, counts, n, _hist = count_reads_device(staged, k)
        keep = counts[:n] >= 2
        g = dbg.DBG(k, keys[:n][keep], counts[:n][keep])
        with cs.record_calls(dbg, "lookup",
                             lambda a: a[0].shape[0]) as calls:
            g.topo
        out[name] = calls[0][:2]
    return out


def range_inputs(dev, n: int, cap: int, L: int, M: int):
    """A sorted (cap, L) int64 table, its first n rows live in duplicate
    runs and the rest the all-ones SENTINEL, and M queries, half of them
    live rows, in random order."""
    import torch
    g = torch.Generator(device=dev).manual_seed(11 * n + L)
    big = torch.iinfo(torch.int64).max
    distinct = n // 4
    keys = torch.randint(-big, big, (distinct, L), generator=g, device=dev)
    keys = keys[torch.sort(keys[:, 0]).indices]
    keys = keys[torch.sort(torch.randint(0, distinct, (n,), generator=g,
                                         device=dev)).values]
    table = torch.full((cap, L), big, dtype=torch.int64, device=dev)
    table[:n] = keys
    picks = table[torch.randint(0, n, (M // 2,), generator=g, device=dev)]
    rand = torch.randint(-big, big, (M - M // 2, L), generator=g, device=dev)
    queries = torch.cat([picks, rand])
    queries = queries[torch.randperm(M, generator=g, device=dev)]
    return table, queries.contiguous()


def launch(fn, table, queries, n: int, mode: str):
    import torch
    from platanus_b_tpu_torch import kernels
    from platanus_b_tpu_torch.ops import search
    cap, L = table.shape
    M = queries.shape[0]
    outs = [torch.empty(M, dtype=torch.int64, device=queries.device)
            for _ in range(1 if mode == "lookup" else 2)]
    steps = search._steps(n if mode == "lookup" else cap)
    rc = fn(table.data_ptr(), queries.data_ptr(), M, L, n, cap, steps,
            kernels.LEX_LOOKUP if mode == "lookup" else kernels.LEX_RANGE,
            outs[0].data_ptr(), outs[1].data_ptr() if len(outs) > 1 else None,
            torch.cuda.current_stream().cuda_stream)
    cs.check(rc == 0, f"lex_search launch failed: cudaError {rc}")
    return outs


def main() -> int:
    it.require_card("lex_search_in_turns.py [OLD_lex_search.cu]",
                    len(sys.argv) <= 2)
    import torch

    from platanus_b_tpu_torch.ops import search
    src = os.path.join(it.CSRC, "lex_search.cu")
    sources = [("current", src, [])]
    sources += [(name, src, flags) for name, flags in VARIANTS]
    if len(sys.argv) == 2:
        sources.insert(0, ("old", os.path.abspath(sys.argv[1]), []))
    fns = {name: it.bind(lib, "platanus_lex_search")
           for name, lib in it.build_all(sources).items()}
    dev = torch.device("cuda")
    from platanus_b_tpu_torch.simulate import simulate_reads
    reads_fa = os.path.join(it.OUT_DIR, "reads_1000000.fa")
    simulate_reads(reads_fa, 1_000_000, 125, 40, 0.003, 123)
    shapes = [(name, "lookup", *args)
              for name, args in adjacency_lookups(dev, reads_fa).items()]
    shapes.append(("polish_range", "range",
                   *range_inputs(dev, *SYNTHETIC_RANGE)))
    for name, mode, table, queries in shapes:
        cap, L = table.shape
        M = queries.shape[0]
        n = SYNTHETIC_RANGE[0] if mode == "range" else cap
        if mode == "lookup":
            want = [search.lookup_plain(table, queries, n)]
        else:
            want = list(search.lookup_range_plain(table, queries, n))
        runs = {k: (lambda fn=fn: launch(fn, table, queries, n, mode))
                for k, fn in fns.items()}
        for k, run in runs.items():
            got = run()
            cs.check(all(torch.equal(a, b) for a, b in zip(got, want)),
                     f"{name}: {k} != plain")
        ms = it.in_turns(runs)
        print(json.dumps({"shape": name, "mode": mode, "rows": n,
                          "capacity": cap, "lanes": L, "queries": M,
                          "ms_in_turns": ms}), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
