#!/usr/bin/env python3
"""unitig_sum.cu variants against each other, in turns, on one CUDA card,
and how long the unitigs of real labelings get.

    git show <commit>:platanus_b_tpu_torch/csrc/unitig_sum.cu \\
        > in_turns_src/unitig_sum_old.cu
    python3 unitig_sum_in_turns.py [in_turns_src/unitig_sum_old.cu]

Survey: runs `assemble -k 32` on chip_smoke's reads (simulate_reads, 125
bp, 0.3 % errors, seed 123) at each of GENOMES_BP and COVERAGES, with
models/dbg.py:unitig_count_sums wrapped where the labeling and
clean._chain_pull call it, and prints one JSON line a run: the calls of
each caller, those with a unitig whose exact count sum reaches 2^24 (the
long path's case), each such unitig's nodes and sum, and the range of
their nodes' counts.

Timing: builds platanus_b_tpu_torch/csrc/unitig_sum.cu with the port's
nvcc flags as it stands and as each VARIANTS entry patches a copy of it
(in_turns.patched: the values a chunk of the long path's fold, the copies
of each unitig's sums, the parent's warp vote in the node pass, and
builds that stop after the convert pass, the placement or the chunk
transfers, for the time of each part), and the
given earlier source if any (the three-pass design of 22515a4, whose C
entry point takes uid, counts, n, num_u, out, a key-sum scratch, a list
and the stream), all at once, into platanus_b_tpu_torch/build/in_turns/.
Runs every build on the survey's largest labeling of each run, on the
call whose long unitigs hold the most nodes, on chip_smoke.LONG_UNITIG
and on chip_smoke.MANY_LONG. Requires every build's sums to equal the
plain version's bit for bit (and the new builds' ulen the exact node
counts; a build that stops early is checked only where no unitig passes
2^24), and times them with in_turns.in_turns (20 launches a time), beside
index_add_ in float32 and, on the labelings, the parent's route to ulen
and the sums (a where, a zeros and an int64 index_add_ before the old
kernel). Prints one JSON line an input (each build's two times; the new
builds' walk stats on the long inputs), then the card's name and power
limit. Exits non-zero without a card, on a failed build or on unequal
results.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import sys

import chip_smoke as cs
import in_turns as it

# (name, {text of csrc/unitig_sum.cu: its replacement})
VARIANTS = [
    ("chunk256", {"kChunk = 512;": "kChunk = 256;"}),
    ("chunk1024", {"kChunk = 512;": "kChunk = 1024;"}),
    ("replicas4", {"kReplicas = 16;": "kReplicas = 4;"}),
    ("replicas8", {"kReplicas = 16;": "kReplicas = 8;"}),
    ("replicas32", {"kReplicas = 16;": "kReplicas = 32;"}),
    # the parent's warp vote: the lanes of one unitig add as one atomic
    ("warp_vote", {"""    if (u >= 0 && u < a.num_u) {
        atomicAdd(pair + u, make_float2(key_of(c), 1.0f));
        if (a.exact_counts) atomicAdd(cnt + u, 1u);
    }""": """    const long long v = u >= 0 && u < a.num_u ? u : -1;
    const unsigned peers = __match_any_sync(__activemask(), v);
    const unsigned key = __reduce_add_sync(
        peers, v >= 0 ? (unsigned)key_of(c) : 0u);
    if (v >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1) {
        atomicAdd(pair + v, make_float2((float)key, (float)__popc(peers)));
        if (a.exact_counts) atomicAdd(cnt + v, (unsigned)__popc(peers));
    }"""}),
    ("stop1", {"    if (L == 0) return;": "    return;"}),
    ("stop2", {"    // b. chunk sums": "    return;\n    // b. chunk sums"}),
    ("stop3", {"    // c. the walk": "    return;\n    // c. the walk"})]
# builds that stop early, for the time of each part: their sums are
# checked only where no unitig passes 2^24
TIMING_ONLY = ("stop1", "stop2", "stop3")
GENOMES_BP = (1_000_000, 4_600_000)
COVERAGES = (40, 100)
EXACT = 1 << 24


class NewBuild:
    """A build of this design: its own scratch, grown once for the
    largest input."""

    def __init__(self, lib):
        self.fn = it.bind(lib, "platanus_unitig_sum")
        self.sizes = it.bind(lib, "platanus_unitig_sum_scratch")
        self.zeroed = self.work = None

    def __call__(self, uid, counts, num_u, ulen=True, stats=None):
        import torch
        n = uid.shape[0]
        sizes = (ctypes.c_longlong * 2)()
        cs.check(self.sizes(n, num_u, sizes) == 0, "scratch sizes refused")
        if self.zeroed is None or self.zeroed.numel() < sizes[0]:
            self.zeroed = torch.zeros(sizes[0], dtype=torch.uint8,
                                      device=uid.device)
        if self.work is None or self.work.numel() < sizes[1]:
            self.work = torch.empty(sizes[1], dtype=torch.uint8,
                                    device=uid.device)
        out = torch.empty(num_u, dtype=torch.float32, device=uid.device)
        lens = torch.empty(num_u, dtype=torch.int64, device=uid.device) \
            if ulen else None
        rc = self.fn(uid.data_ptr(), counts.data_ptr(), n, num_u,
                     out.data_ptr(), lens.data_ptr() if ulen else None,
                     stats.data_ptr() if stats is not None else None,
                     self.zeroed.data_ptr(), self.zeroed.numel(),
                     self.work.data_ptr(), self.work.numel(),
                     torch.cuda.current_stream().cuda_stream)
        cs.check(rc == 0, f"unitig_sum launch failed: cudaError {rc}")
        return out, lens


class OldBuild:
    """The parent's three-pass design; ulen the parent's way (where,
    zeros and an int64 index_add_) when asked for."""

    def __init__(self, lib):
        vp, cll = ctypes.c_void_p, ctypes.c_longlong
        self.fn = lib.platanus_unitig_sum
        self.fn.restype = ctypes.c_int
        self.fn.argtypes = [vp, vp, cll, cll, vp, vp, vp, vp]

    def __call__(self, uid, counts, num_u, ulen=True, stats=None):
        import torch

        from platanus_b_tpu_torch.models import dbg
        lens = dbg._per_unitig_sum(uid, torch.ones_like(uid), num_u) \
            if ulen else None
        out = torch.empty(num_u, dtype=torch.float32, device=uid.device)
        sums = torch.empty(num_u + 1, dtype=torch.int64, device=uid.device)
        longs = torch.empty(max(num_u, 1), dtype=torch.int32,
                            device=uid.device)
        rc = self.fn(uid.data_ptr(), counts.data_ptr(), uid.shape[0], num_u,
                     out.data_ptr(), sums.data_ptr(), longs.data_ptr(),
                     torch.cuda.current_stream().cuda_stream)
        cs.check(rc == 0, f"old unitig_sum launch failed: cudaError {rc}")
        return out, lens


@contextlib.contextmanager
def long_unitig_survey():
    """unitig_count_sums wrapped where dbg._label_core and
    clean._chain_pull call it; yields (records, kept): a record a call
    (its caller, nodes, unitigs, and each unitig whose exact sum reaches
    2^24: its nodes and sum, longest first), and kept["labeling"] /
    kept["long"] the (uid, counts, num_u) of the largest labeling and of
    the call whose long unitigs hold the most nodes."""
    import torch

    from platanus_b_tpu_torch.models import clean, dbg
    orig = dbg.unitig_count_sums
    records: list = []
    kept: dict = {}
    best = {"labeling": -1, "long": 0}

    def wrapper(uid, counts, num_u, with_ulen=False):
        sums = dbg._per_unitig_sum(uid, counts, num_u)
        lens = dbg._per_unitig_sum(uid, torch.ones_like(uid), num_u)
        big = torch.nonzero(sums >= EXACT).flatten()
        order = torch.argsort(lens[big], descending=True)
        rec = {"from": "labeling" if with_ulen else "chain_pull",
               "nodes": uid.shape[0], "unitigs": num_u,
               "long_nodes": lens[big][order].tolist(),
               "long_sums": sums[big][order].tolist()}
        if big.numel():                  # the counts of the long unitigs
            c = counts[torch.isin(uid, big)].to(torch.float64)
            rec["long_counts"] = {
                "min": c.min().item(), "mean": c.mean().item(),
                "max": c.max().item(),
                "p1_p99": torch.quantile(
                    c[::max(1, c.numel() >> 20)],
                    torch.tensor([0.01, 0.99], dtype=torch.float64,
                                 device=c.device)).tolist()}
        records.append(rec)
        held = sum(rec["long_nodes"])
        for key, size, want in (("labeling", uid.shape[0], with_ulen),
                                ("long", held, True)):
            if want and size > best[key]:
                best[key] = size
                kept[key] = (uid.clone(), counts.clone(), num_u)
        return orig(uid, counts, num_u, with_ulen)

    dbg.unitig_count_sums = clean.unitig_count_sums = wrapper
    try:
        yield records, kept
    finally:
        dbg.unitig_count_sums = clean.unitig_count_sums = orig


def survey(dev) -> dict:
    """The survey's JSON line for each run of `assemble -k 32` at
    GENOMES_BP x COVERAGES; returns {name: (uid, counts, num_u)}: each
    run's largest labeling and, where there is one, its call whose long
    unitigs hold the most nodes."""
    from platanus_b_tpu_torch.commands.main import main as cli_main
    from platanus_b_tpu_torch.simulate import simulate_reads
    inputs = {}
    for cov in COVERAGES:
        for bp in GENOMES_BP:
            tag = f"{bp}" if cov == 40 else f"{bp}_{cov}x"
            reads = os.path.join(it.OUT_DIR, f"reads_{tag}.fa")
            simulate_reads(reads, bp, 125, cov, 0.003, 123)
            with long_unitig_survey() as (records, kept):
                rc = cli_main(["assemble", "-f", reads, "-k", "32", "-o",
                               os.path.join(it.OUT_DIR, f"out_{tag}")])
            cs.check(rc == 0, f"assemble at {bp} bp, {cov}x exited {rc}")
            os.remove(reads)
            calls = {who: sum(r["from"] == who for r in records)
                     for who in ("labeling", "chain_pull")}
            with_long = [r for r in records if r["long_nodes"]]
            print(json.dumps({
                "survey": tag, "genome_bp": bp, "coverage": cov,
                "calls": calls,
                "calls_with_long": {who: sum(r["from"] == who
                                             for r in with_long)
                                    for who in calls},
                "largest_labeling": {"nodes": kept["labeling"][0].shape[0],
                                     "unitigs": kept["labeling"][2]},
                "with_long": [{"call": records.index(r), **r}
                              for r in with_long]}), flush=True)
            inputs[f"labeling_{tag}"] = kept["labeling"]
            if "long" in kept:
                inputs[f"most_long_{tag}"] = kept["long"]
    return inputs


def long_inputs(dev):
    import torch

    from platanus_b_tpu_torch.simulate import (coverage_counts,
                                               interleaved_unitigs)
    lu, ml = cs.LONG_UNITIG, cs.MANY_LONG
    uid, counts = interleaved_unitigs(
        ml["seed"], ml["nodes"], ml["unitigs"], ml["long"], ml["long_lo"],
        ml["long_hi"], ml["lo"], ml["hi"])
    return {"long_unitig_300k": (
                torch.zeros(lu["nodes"], dtype=torch.int64, device=dev),
                torch.from_numpy(coverage_counts(
                    lu["seed"], lu["nodes"], lu["lo"], lu["hi"],
                    lu["total"])).to(dev), 1),
            "many_long": (torch.from_numpy(uid).to(dev),
                          torch.from_numpy(counts).to(dev), ml["unitigs"])}


def main() -> int:
    it.require_card("unitig_sum_in_turns.py [OLD_unitig_sum.cu]",
                    len(sys.argv) <= 2)
    import torch

    from platanus_b_tpu_torch.models import dbg
    src = os.path.join(it.CSRC, "unitig_sum.cu")
    sources = [("current", src, [])]
    sources += [(name, it.patched(src, f"unitig_sum_{name}", edits), [])
                for name, edits in VARIANTS]
    if len(sys.argv) == 2:
        sources.insert(0, ("old", os.path.abspath(sys.argv[1]), []))
    builds = {name: (OldBuild(lib) if name == "old" else NewBuild(lib))
              for name, lib in it.build_all(sources).items()}
    dev = torch.device("cuda")
    inputs = survey(dev)
    inputs.update(long_inputs(dev))
    for name, (uid, counts, num_u) in inputs.items():
        uid = uid.contiguous()
        counts = counts.to(torch.int64).contiguous()
        want = dbg.unitig_count_sums_plain(uid.cpu(), counts.cpu(), num_u)
        lens = dbg._per_unitig_sum(uid, torch.ones_like(uid), num_u)
        runs = {k: (lambda b=b: b(uid, counts, num_u))
                for k, b in builds.items()}
        slot = torch.where(uid >= 0, uid, num_u)
        counts_f = counts.to(torch.float32)
        runs["index_add_"] = lambda: torch.zeros(
            num_u + 1, device=dev).index_add_(0, slot, counts_f)
        if "old" in builds:
            runs["old_sums_only"] = lambda: builds["old"](uid, counts, num_u,
                                                          ulen=False)
        walks = {}
        has_long = bool((dbg._per_unitig_sum(uid, counts, num_u)
                         >= EXACT).any())
        for k, b in builds.items():
            got, got_len = b(uid, counts, num_u)
            if k in TIMING_ONLY and has_long:
                continue
            cs.check(torch.equal(got.cpu(), want), f"{name}: {k} != plain")
            cs.check(torch.equal(got_len, lens), f"{name}: {k} ulen wrong")
            if k != "old":
                stats = torch.zeros(4, dtype=torch.int64, device=dev)
                b(uid, counts, num_u, stats=stats)
                walks[k] = stats.tolist()
        print(json.dumps({"input": name, "nodes": uid.shape[0],
                          "unitigs": num_u, "ms_in_turns": it.in_turns(runs),
                          "walk_stats": walks}), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
