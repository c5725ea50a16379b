#!/usr/bin/env python3
"""Smoke run of platanus_b_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--genome-bp 1000000|4600000]

Phases, one JSON line each; any failure exits non-zero:

1. environment: card name and power limit (nvidia-smi), torch and CUDA
   versions, kernel build time (one nvcc per source, all at once);
2. each CUDA kernel against its plain PyTorch version on the card (exact
   equality), with both times at the main path's shapes, the bound there
   (the larger of the bytes each input read once and each output written
   once take at 3.35 TB/s, and the operations take at 67 T/s), what sets
   it, and the kernel's share of it (for ungap_align with the count of ok
   slots its bound is taken over; for edit_distance with the diagonals of
   its longest pair and the time per diagonal, for chain_dp with the steps
   of its longest group and the time per step, since those serial chains
   and not the bound set their times; chain_dp also against a second
   bound, its serial chain: the longest group's steps times
   CHAIN_CYCLES_PER_STEP over the SM clock that nvidia-smi reads while
   the kernel runs), edit_distance on one set per tier,
   and chain_dp (f and prev bit for bit) on the buckets of phases 7 and 8:
   map-ont at caps 2048, 4096 and 8192, asm10 at caps 4096 and 8192, and
   one group pair at cap 2**17, whose plain version runs on the card when
   the smaller buckets' time a step puts it under 30 s, else on a CPU copy
   of the same inputs;
3. the main path: `assemble -k 32` through the port's CLI on the parity
   dataset (parity/run_parity.py:121 simulate(genome_bp, 125, 40, 0.003,
   123)); the sorted canonical contig set must hash to the value recorded
   in parity/PARITY_assemble_<genome_bp>.json, and kmer_extract,
   list_rank, lex_search and unitig_sum must have run. The run records the
   inputs of its largest labeling's first doubling pass, of its largest
   lookups (the graph's adjacency, keys of several lanes and of one lane)
   and of its largest labeling's count sums; then, in phase 2's format
   (the "graph_kernels" line, launches not counted), list_rank against its
   plain version (ptr, rank, anchor, the steps that did work and the live
   flag bit for bit) on that pass and on the two passes and the min-pair
   loop of a synthetic labeling of the same size whose one junction-free
   cycle holds half of the oriented ids (simulate.label_links), each with
   the steps that did work and the time a step; lex_search through lookup
   against its plain version on the adjacency's lookups of several lanes
   and of one lane, the latter beside torch.searchsorted alone and with the
   equality gather; unitig_sum against its plain version (numpy's float32
   add.at; ulen against the exact node counts) on the labeling's sums, on
   one unitig of 300,000 nodes whose float32 sum passes 2^24 (LONG_UNITIG:
   ucov 80, the exact sum's 79), on 12 such unitigs of 250-450 k nodes
   shuffled among the labeling's 5,754,499 nodes of 64,267 unitigs at
   4.6 Mbp (MANY_LONG, a stress case) and on the shape of the one call
   with such unitigs that `assemble` makes at 4.6 Mbp and 100x (two of
   612-694 k nodes among 22 unitigs, FINAL_100X), beside index_add_ in
   float32, the long sets with their walk's steps and replays. Bounds
   count each input read once and each output written once;
4. the bubble configuration: `assemble -u 0.1` on two haplotypes; the
   output files must hash to platanus_b_tpu_torch/smoke_expected.json
   (made by the JAX package on the CPU) and the edit_distance kernel must
   have run;
5. an `iterate` round without solve_dbg through the port's CLI, from its
   work directory with relative paths: `assemble -kmer_occ_only`,
   `kmer_divide`, `polish`, `gap_close -reduce_redundancy` and `merge` on
   the gap-closing dataset of parity/gapclose_bench.py:50-72 (a 1.2 Mbp
   scaffold with 1,000 gaps, 240,240 read pairs, made with tests/simdata.py);
   every output file must hash to smoke_expected.json, and kmer_extract,
   ungap_align and lex_search must have run; lex_search's range mode
   against its plain version on the largest lookup_range of polish (the
   mapper's padded index, beside two torch.searchsorted calls on its live
   rows; the "mapper_kernels" line); then the round once
   more under torch.profiler for each command's largest kernels and
   copies;
6. a whole `iterate -i 1` through the port's CLI (count, kmer_divide,
   solve_dbg -unphase, polish, gap_close, final divide, final polish) on
   phase 5's reads and its scaffold split at the gaps into 1,001 contigs;
   every file it writes must hash to smoke_expected.json, kmer_extract and
   ungap_align must have run, and the scaffolder must have joined contigs;
   then its solve_dbg stage once more under torch.profiler for its
   largest kernels and copies;
7. the phasing flow: the default `solve_dbg -c contigs.fa -o phase` (no
   -unphase) on a 1 Mbp homozygous contig and two 200 kbp haplotypes 0.3 %
   apart (simulate.simulate_phase_contigs); its haplotig pairing aligns
   each haplotype with the asm10 long-read aligner, whose segments go
   through edit_distance at band 128 in one launch. The six phasing files
   must hash to smoke_expected.json, edit_distance, kmer_extract and
   chain_dp must have run; it prints the segments and their longest
   pair's diagonals, the chaining buckets and the largest of them;
8. the hybrid pipeline of README.md: `iterate -i 2 -o hy -c contigs.fa
   -IP1 r1.fa r2.fa -ont ont.fa` on the genome and read pairs of
   parity/PARITY_iterate_1000000.json (1 Mbp, 125 bp pairs, 40x), the
   genome cut into 10-30 kbp contigs with 50-500 bp dropped between them
   (simulate.simulate_fragmented_contigs), and 10x ONT-like long reads
   with 2 % errors, indels included (simulate.simulate_long_reads). Both
   rounds and the final divide align the long reads with the map-ont
   preset (kmer_extract in the sketch, the chaining DP, edit_distance at
   band 128), round 2 merges and extends, and round 1's result is
   combined once (asm10). Every file iterate writes must hash to
   smoke_expected.json (made by the JAX package with its non-CPU
   segment verification forced), and edit_distance, kmer_extract,
   ungap_align and chain_dp must have run. It prints the wall, each
   stage's wall, the walls of the aligner's parts, the segments of each
   edit_distance call and their longest pair's diagonals, and the
   chaining buckets (cap, groups) with the largest of them.
9. the multi-process layer (platanus_b_tpu_torch/parallel/): (a) `python
   -m torch.distributed.run --standalone --nproc-per-node 2 -m
   platanus_b_tpu_torch assemble -k 32 -f a.fa b.fa -o mp`, two ranks
   sharing the card, on phase 3's reads cut into two files (host_shard
   gives each rank one; with --genome-bp 4600000 each half passes
   host_read_plan's 64 MiB and both are split by byte range): the
   contig set must hash to the parity record, the files must equal
   phase 3's bytes, and rank 1 must write nothing; (b) the same launch
   of phase 5's `assemble -kmer_occ_only -n 1 -k 62`, whose two files
   must hash to smoke_expected.json; (c) sharded_count, sharded_adjacency
   and sharded_map over NCCL, one rank for each card
   (torch.multiprocessing.spawn), each against the single-process port
   on the same card. It prints the walls of (a) and (b) from launch to
   exit beside phase 3's and phase 5's single-process walls, each rank's
   peak device memory and kernel launches.

Each of phases 3-8 sets the launch counts to 0 just before it and reads
them just after; phase 9's ranks are processes of their own, which count
from 0 and report their counts (the CLI's DEVICE REPORT log line, (c)'s
result file). Then a {"kernels": [...]} line, the nvidia-smi line, and
the last line {"ok": true, "device": {...}}. Without a CUDA card it exits
1 and prints no result. Working files go under
platanus_b_tpu_torch/build/smoke/.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PHASE = {"name": "start"}

# phase 5: the dataset of parity/gapclose_bench.py at its defaults, and the
# round's commands (iterate_cmd.py:88-149 without solve_dbg), run from the
# work directory so that output names carry no directory
ROUND_DATASET = {"n_gaps": 1000, "gap_len": 150, "segment": 1200,
                 "coverage": 40.0, "read_len": 100, "insert": 400, "sd": 40,
                 "error": 0.002, "seed": 42}
ROUND_INPUTS = ("scaffold.fa", "r1.fa", "r2.fa")
ROUND_STEPS = [
    ["assemble", "-kmer_occ_only", "-n", "1", "-k", "62", "-f", "r1.fa",
     "r2.fa", "-o", "occ"],
    ["kmer_divide", "-k", "occ_kmer_occ.bin", "-f", "scaffold.fa", "-o",
     "round"],
    ["polish", "-c", "scaffold.fa", "-IP1", "r1.fa", "r2.fa", "-o", "round"],
    ["gap_close", "-reduce_redundancy", "-c", "round_polished_scaffold.fa",
     "-IP1", "r1.fa", "r2.fa", "-o", "round"],
    ["merge", "-f", "round_gapClosed_polished_scaffold.fa",
     "round_extraContig.fa", "-k", "1.0", "-l", "1.0", "-o", "round"],
]

# phase 6: a whole `iterate -i 1` (iterate_cmd.py:88-163) on phase 5's reads
# and its scaffold split at the gaps into contigs, from the work directory
ITERATE_INPUTS = ("contigs.fa", "r1.fa", "r2.fa")
ITERATE_ARGV = ["iterate", "-i", "1", "-o", "it", "-c", "contigs.fa", "-IP1",
                "r1.fa", "r2.fa"]

# phase 7: the phasing flow (the default solve_dbg) on a bacterial assembly
# with one heterozygous region, from the work directory
PHASING_DATASET = {"homo_bp": 1_000_000, "hap_bp": 200_000, "het_rate": 0.003,
                   "seed": 5}
PHASING_ARGV = ["solve_dbg", "-c", "contigs.fa", "-o", "phase"]
PHASING_OUTPUTS = ("primaryBubble.fa", "secondaryBubble.fa",
                   "nonBubbleHetero.fa", "nonBubbleOther.fa",
                   "bubbleRelation.tsv", "phasedScaffoldComponent.bed")

# phase 8: the hybrid `iterate` (README.md's main pipeline) on the genome and
# read pairs of parity/PARITY_iterate_1000000.json (parity/run_parity.py
# simulate_paired: tests/simdata.py in its generator order), the genome cut
# into contigs of 10-30 kbp with 50-500 bp dropped between them, and
# ONT-like long reads (10x, exponential lengths of mean 8 kbp and at least
# 1 kbp, 1 % substitutions, 0.5 % insertions, 0.5 % deletions, both
# strands); from the work directory
HYBRID_DATASET = {"genome_bp": 1_000_000, "read_len": 125, "insert": 400,
                  "sd": 50, "coverage": 40.0, "error": 0.003, "seed": 123,
                  "contig_bp": [10_000, 30_000], "dropped_bp": [50, 500],
                  "contig_seed": 6, "max_k": 63, "ont_coverage": 10.0,
                  "ont_mean_bp": 8000, "ont_sub": 0.01, "ont_ins": 0.005,
                  "ont_del": 0.005, "ont_seed": 7}
HYBRID_INPUTS = ("contigs.fa", "r1.fa", "r2.fa", "ont.fa")
HYBRID_ARGV = ["iterate", "-i", "2", "-o", "hy", "-c", "contigs.fa", "-IP1",
               "r1.fa", "r2.fa", "-ont", "ont.fa"]


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    emit({"phase": PHASE["name"], "ok": False, "error": msg})
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def nvidia_smi_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> dict:
    """Most registers and stack bytes over each kernel's instantiations,
    from nvcc's -Xptxas=-v output."""
    out: dict = {}
    name = None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = next((k for k in ("edit_distance", "kmer_extract",
                                     "ungap_align", "chain_dp", "unitig_sum")
                         if k in ln), "other")
        elif name and "Used" in ln and "registers" in ln:
            words = ln.replace(",", " ").split()
            regs = int(words[words.index("registers") - 1])
            stack = (int(words[words.index("bytes") - 1])
                     if "stack" in ln else 0)
            rec = out.setdefault(name, {"max_registers": 0, "max_stack_bytes": 0})
            rec["max_registers"] = max(rec["max_registers"], regs)
            rec["max_stack_bytes"] = max(rec["max_stack_bytes"], stack)
    return out


# ---------------------------------------------------------------------------
# parity helpers (parity/run_parity.py:44-75)
# ---------------------------------------------------------------------------

_COMP = str.maketrans("ACGTN", "TGCAN")


def read_fasta(path: str) -> list[str]:
    seqs: list[str] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                seqs.append("")
            else:
                seqs[-1] += line.upper()
    return seqs


def sorted_set_sha256(seqs: list[str]) -> str:
    canon = sorted(min(s, s.translate(_COMP)[::-1]) for s in seqs)
    return hashlib.sha256("\n".join(canon).encode()).hexdigest()


def file_sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


# ---------------------------------------------------------------------------
# phase 5 helpers (also used by tests/torch_smoke_expected.py)
# ---------------------------------------------------------------------------

def make_round_dataset(data: str, ds: dict) -> dict:
    """parity/gapclose_bench.py:50-72 with tests/simdata.py, the same calls
    in the same order: a genome, a scaffold copy with `gap_len` Ns at each
    segment boundary, innie pairs from the genome. Returns the files'
    sha256."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import simdata
    os.makedirs(data, exist_ok=True)
    rng = np.random.default_rng(ds["seed"])
    genome = simdata.random_genome(rng, (ds["n_gaps"] + 1) * ds["segment"])
    scaf = list(genome)
    for g in range(ds["n_gaps"]):
        mid = (g + 1) * ds["segment"] - ds["gap_len"] // 2
        for i in range(mid, mid + ds["gap_len"]):
            scaf[i] = "N"
    scaffold = "".join(scaf)
    with open(os.path.join(data, "scaffold.fa"), "w") as f:
        f.write(f">scaf1_len{len(scaffold)}_cov40_read{ds['read_len']}"
                f"_maxK62\n")
        for i in range(0, len(scaffold), 80):
            f.write(scaffold[i: i + 80] + "\n")
    fwd, rev = simdata.paired_reads(rng, genome, ds["read_len"], ds["insert"],
                                    ds["sd"], ds["coverage"],
                                    error_rate=ds["error"])
    simdata.write_fasta(os.path.join(data, "r1.fa"), fwd)
    simdata.write_fasta(os.path.join(data, "r2.fa"), rev)
    return {name: file_sha256(os.path.join(data, name))
            for name in ROUND_INPUTS}


def run_round(work: str, data: str, cli_main) -> dict:
    """ROUND_STEPS through `cli_main` from `work`, the inputs copied there;
    returns each command's wall (s)."""
    os.makedirs(work, exist_ok=True)
    for name in ROUND_INPUTS:
        shutil.copy(os.path.join(data, name), os.path.join(work, name))
    walls = {}
    cwd = os.getcwd()
    os.chdir(work)
    try:
        for argv in ROUND_STEPS:
            t0 = time.perf_counter()
            rc = cli_main(list(argv))
            walls[argv[0]] = time.perf_counter() - t0
            if rc != 0:
                raise RuntimeError(f"{' '.join(argv)} exited {rc}")
    finally:
        os.chdir(cwd)
    return walls


def round_hashes(work: str) -> dict:
    """sha256 of every file the round wrote."""
    return {name: file_sha256(os.path.join(work, name))
            for name in sorted(os.listdir(work)) if name not in ROUND_INPUTS}


# ---------------------------------------------------------------------------
# phase 6 helpers (also used by tests/torch_smoke_expected.py)
# ---------------------------------------------------------------------------

def make_iterate_contigs(data: str, ds: dict) -> str:
    """Phase 5's scaffold.fa split at its N runs into ITERATE_INPUTS'
    contigs.fa (headers seq{i}_len{L}_cov40_read{read_len}_maxK62), the
    shape of a fragmented short-read assembly; returns its sha256."""
    scaffold = read_fasta(os.path.join(data, "scaffold.fa"))[0]
    parts = [p for p in scaffold.split("N") if p]
    path = os.path.join(data, "contigs.fa")
    with open(path, "w") as f:
        for i, p in enumerate(parts, start=1):
            f.write(f">seq{i}_len{len(p)}_cov40_read{ds['read_len']}"
                    f"_maxK62\n")
            for j in range(0, len(p), 80):
                f.write(p[j: j + 80] + "\n")
    return file_sha256(path)


def run_iterate(work: str, data: str, cli_main) -> float:
    """ITERATE_ARGV through `cli_main` from `work`, the inputs copied
    there; returns its wall (s)."""
    os.makedirs(work, exist_ok=True)
    for name in ITERATE_INPUTS:
        shutil.copy(os.path.join(data, name), os.path.join(work, name))
    cwd = os.getcwd()
    os.chdir(work)
    try:
        t0 = time.perf_counter()
        rc = cli_main(list(ITERATE_ARGV))
        wall = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"{' '.join(ITERATE_ARGV)} exited {rc}")
    finally:
        os.chdir(cwd)
    return wall


def iterate_hashes(work: str, o: str = "it") -> dict:
    """sha256 of every file `iterate -o <o>` wrote: the final assembly and
    each file under its intermediate-results directory, by relative path."""
    out = {f"{o}_iterativeAssembly.fa":
           file_sha256(os.path.join(work, f"{o}_iterativeAssembly.fa"))}
    inter = os.path.join(work, f"{o}_iterateIntermediateResults")
    for root, _dirs, files in os.walk(inter):
        for name in files:
            path = os.path.join(root, name)
            out[os.path.relpath(path, work)] = file_sha256(path)
    return dict(sorted(out.items()))


def fasta_count(path: str) -> int:
    with open(path) as f:
        return sum(1 for line in f if line.startswith(">"))


# ---------------------------------------------------------------------------
# phase 7 helpers (also used by tests/torch_smoke_expected.py)
# ---------------------------------------------------------------------------

def make_phasing_contigs(work: str, ds: dict) -> str:
    """PHASING_DATASET's contigs.fa in `work`; returns its sha256."""
    from platanus_b_tpu_torch.simulate import simulate_phase_contigs
    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, "contigs.fa")
    simulate_phase_contigs(path, ds["homo_bp"], ds["hap_bp"], ds["het_rate"],
                           ds["seed"])
    return file_sha256(path)


def run_from(work: str, argv: list[str], cli_main) -> float:
    """argv through `cli_main` from `work`; returns its wall (s)."""
    cwd = os.getcwd()
    os.chdir(work)
    try:
        t0 = time.perf_counter()
        rc = cli_main(list(argv))
        wall = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"{' '.join(argv)} exited {rc}")
    finally:
        os.chdir(cwd)
    return wall


def run_phasing(work: str, cli_main) -> float:
    """PHASING_ARGV through `cli_main` from `work`; returns its wall (s)."""
    return run_from(work, PHASING_ARGV, cli_main)


def phasing_hashes(work: str) -> dict:
    return {name: file_sha256(os.path.join(work, f"phase_{name}"))
            for name in PHASING_OUTPUTS}


# ---------------------------------------------------------------------------
# phase 8 helpers (also used by tests/torch_smoke_expected.py)
# ---------------------------------------------------------------------------

def make_hybrid_dataset(work: str, ds: dict) -> dict:
    """HYBRID_INPUTS in `work` from HYBRID_DATASET; returns their sha256."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import simdata

    from platanus_b_tpu_torch.simulate import (simulate_fragmented_contigs,
                                               simulate_long_reads)
    os.makedirs(work, exist_ok=True)
    rng = np.random.default_rng(ds["seed"])
    genome = simdata.random_genome(rng, ds["genome_bp"])
    fwd, rev = simdata.paired_reads(rng, genome, ds["read_len"], ds["insert"],
                                    ds["sd"], ds["coverage"],
                                    error_rate=ds["error"])
    simdata.write_fasta(os.path.join(work, "r1.fa"), fwd)
    simdata.write_fasta(os.path.join(work, "r2.fa"), rev)
    del fwd, rev
    simulate_fragmented_contigs(os.path.join(work, "contigs.fa"), genome,
                                *ds["contig_bp"], *ds["dropped_bp"],
                                ds["contig_seed"], ds["read_len"],
                                ds["max_k"])
    simulate_long_reads(os.path.join(work, "ont.fa"), genome,
                        ds["ont_coverage"], ds["ont_mean_bp"], ds["ont_sub"],
                        ds["ont_ins"], ds["ont_del"], ds["ont_seed"])
    return {name: file_sha256(os.path.join(work, name))
            for name in HYBRID_INPUTS}


@contextlib.contextmanager
def aligner_split(walls: dict, segments: list, buckets: list):
    """Wrap the parts of the port's long-read aligner so that each call
    adds its host wall (s; the results come back to the host) to
    walls[part]: align_batch whole, the minimizer sketch, anchor
    collection, the chaining DP (_chain_groups) and inside it the K4
    calls (synchronised), segment verification, and inside it the K1
    calls, the host re-measures (hetero.align_scaffold) and the affine
    scores. Each K1 call appends (segments, longest pair's diagonals) to
    `segments`, each K4 call its bucket's (cap, groups) to `buckets`."""
    import torch

    from platanus_b_tpu_torch.models import hetero, longread
    from platanus_b_tpu_torch.ops import align
    aligner = longread.LongReadAligner
    parts = {"align_batch": (aligner, "align_batch"),
             "sketch": (longread, "sketch"),
             "collect_groups": (aligner, "_collect_groups"),
             "chain_groups": (aligner, "_chain_groups"),
             "chain_dp calls": (longread, "chain_dp"),
             "verify": (longread, "verify_alignments_batched"),
             "edit_distance calls": (align, "banded_edit_distance"),
             "host re-measure": (hetero, "align_scaffold"),
             "affine scores": (longread, "_affine_scores_batched")}
    saved = {name: getattr(obj, attr) for name, (obj, attr) in parts.items()}
    depth = {"verify": 0}

    def wrap(name, fn):
        def wrapper(*a, **kw):
            if name == "host re-measure" and not depth["verify"]:
                return fn(*a, **kw)
            if name == "edit_distance calls":
                segments.append((len(a[0]), max(
                    (len(x) + len(y) - 1 for x, y in zip(a[0], a[1])),
                    default=0)))
            if name == "chain_dp calls":
                buckets.append(tuple(a[0].shape[::-1]))
            depth["verify"] += name == "verify"
            t0 = time.perf_counter()
            try:
                out = fn(*a, **kw)
                if name == "chain_dp calls" and a[0].is_cuda:
                    torch.cuda.synchronize()
                return out
            finally:
                walls[name] = walls.get(name, 0.0) + time.perf_counter() - t0
                depth["verify"] -= name == "verify"
        return wrapper

    for name, (obj, attr) in parts.items():
        setattr(obj, attr, wrap(name, saved[name]))
    try:
        yield
    finally:
        for name, (obj, attr) in parts.items():
            setattr(obj, attr, saved[name])


# ---------------------------------------------------------------------------
# phase 9 helpers: the multi-process layer (platanus_b_tpu_torch/parallel/)
# ---------------------------------------------------------------------------

MP_RANKS = 2
MP_ASSEMBLE_ARGV = ["assemble", "-k", "32", "-f", "a.fa", "b.fa", "-o", "mp"]
MP_OCC_ARGV = ["assemble", "-kmer_occ_only", "-n", "1", "-k", "62", "-f",
               "r1.fa", "r2.fa", "-o", "mpocc"]
# (c)'s mapping: __graft_entry__.py:79-91's shape, a 50 kbp genome as two
# 25 kbp contigs, key 21, 2048 reads of 100 bp for each rank
MP_MAP = {"genome_bp": 50_000, "contig_bp": 25_000, "key": 21,
          "read_len": 100, "reads_per_rank": 2048, "seed": 1}
DEVICE_REPORT = re.compile(r"^\[\w*?(\d+)\]:#### DEVICE REPORT #### (\{.*\})$")


def split_records(src: str, dst_a: str, dst_b: str) -> None:
    """The FASTA at `src` as two files, cut at the record boundary nearest
    its middle byte."""
    with open(src, "rb") as f:
        data = f.read()
    cut = data.find(b"\n>", len(data) // 2) + 1 or len(data)
    with open(dst_a, "wb") as f:
        f.write(data[:cut])
    with open(dst_b, "wb") as f:
        f.write(data[cut:])


def torchrun(argv: list[str], work: str, nproc: int) -> dict:
    """`python -m torch.distributed.run --standalone --nproc-per-node N -m
    platanus_b_tpu_torch <argv>` from `work`, each rank's output tagged
    [default<r>]: by --tee. Returns the wall from launch to exit, each
    rank's DEVICE REPORT (peak device bytes, kernel launches, stage times,
    stage records, seconds since its logger's start) and the output, which
    is also kept in `work`. A failed rank fails the run."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    # one host: gloo binds the loopback device instead of resolving the
    # host name
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(nproc), "--tee", "3", "-m",
           "platanus_b_tpu_torch", *argv]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=work, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.communicate()
        fail(f"{' '.join(argv)}: torchrun outlived 600 s")
    wall = time.perf_counter() - t0
    with open(os.path.join(work, f"torchrun_{argv[-1]}.log"), "w") as f:
        f.write(out)
    check(proc.returncode == 0, f"torchrun {' '.join(argv)} exited "
          f"{proc.returncode}:\n{out[-3000:]}")
    reports = {}
    for line in out.splitlines():
        m = DEVICE_REPORT.match(line)
        if m:
            reports[int(m.group(1))] = json.loads(m.group(2))
    check(sorted(reports) == list(range(nproc)),
          f"device reports of ranks {sorted(reports)} of {nproc}")
    return {"wall_s": wall, "reports": [reports[r] for r in range(nproc)],
            "log": out}


def device_layer_rank(rank: int, world: int, port: int, reads_fa: str,
                      out_dir: str) -> None:
    """Phase 9 (c), one rank of torch.multiprocessing.spawn: the device
    layer over NCCL (sharded_count at k 32 on this rank's rows of the
    reads, sharded_adjacency on its shard, sharded_map at MP_MAP's shape),
    then each result against the single-process port on the same card:
    count_reads_device, the DBG's adjacency and map_reads. Writes
    out_dir/rank<r>.json; a mismatch raises."""
    import torch
    import torch.distributed as dist

    from platanus_b_tpu_torch import kernels
    from platanus_b_tpu_torch.models.assemble_core import (
        StagedReads, count_reads_device, stage_read_files)
    from platanus_b_tpu_torch.models.dbg import DBG
    from platanus_b_tpu_torch.models.mapper import ContigIndex, map_reads
    from platanus_b_tpu_torch.ops.keys import lexsort
    from platanus_b_tpu_torch.parallel import sharding

    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        group = dist.group.WORLD
        reads = stage_read_files([reads_fa], dev)
        a, b = (rank * reads.num_reads // world,
                (rank + 1) * reads.num_reads // world)
        local = StagedReads(reads.codes[a:b], reads.lengths[a:b],
                            reads.has_n, reads.max_len)
        m = MP_MAP
        rng = np.random.default_rng(m["seed"])
        genome = rng.integers(0, 4, size=m["genome_bp"], dtype=np.uint8)
        n_map = world * m["reads_per_rank"]
        starts = rng.integers(0, m["genome_bp"] - m["read_len"], size=n_map)
        codes = genome[starts[:, None] + np.arange(m["read_len"])[None, :]]
        index = ContigIndex([genome[: m["contig_bp"]],
                             genome[m["contig_bp"]:]],
                            key_length=m["key"], device=dev)
        rows = slice(rank * m["reads_per_rank"],
                     (rank + 1) * m["reads_per_rank"])
        map_codes = torch.from_numpy(codes[rows]).to(dev)
        map_lens = torch.full((m["reads_per_rank"],), m["read_len"],
                              dtype=torch.int32, device=dev)
        torch.cuda.synchronize()
        for key in kernels.LAUNCHES:
            kernels.LAUNCHES[key] = 0
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        keys, counts, hist = sharding.sharded_count(local, 32, group)
        out, junc, n_junc, n_edge = sharding.sharded_adjacency(
            keys, counts, 32, group)
        ids, offs, mhist = sharding.sharded_map(index, map_codes, map_lens,
                                                m["key"], group)
        torch.cuda.synchronize()
        rec = {"rank": rank, "world": world,
               "wall_s": time.perf_counter() - t0,
               "launches": dict(kernels.LAUNCHES),
               "peak_device_bytes": torch.cuda.max_memory_allocated(dev),
               "shard_keys": int(keys.shape[0])}

        # the single-process port on the same card, on every read
        all_k, all_c, all_o, all_j = (
            torch.cat(sharding.all_gather_rows(t, group))
            for t in (keys, counts, out, junc.to(torch.uint8)))
        perm = lexsort(all_k)
        want_k, want_c, n, want_h = count_reads_device(reads, 32)
        if not (torch.equal(all_k[perm], want_k)
                and torch.equal(all_c[perm], want_c)
                and np.array_equal(hist.cpu().numpy(), want_h)):
            raise AssertionError("sharded_count != count_reads_device")
        _si, _so, want_o, outdeg, want_j = DBG(32, want_k, want_c).topo
        if not (torch.equal(all_o[perm].to(torch.int64),
                            want_o.T.to(torch.int64))
                and torch.equal(all_j[perm].bool(), want_j)
                and n_junc == int(want_j.sum())
                and n_edge == int(outdeg.sum())):
            raise AssertionError("sharded_adjacency != the DBG's adjacency")
        want_ids, want_offs = map_reads(index, codes, np.full(
            n_map, m["read_len"], np.int32), (m["key"],))
        want_hist = np.bincount(np.abs(want_ids[want_ids != 0]) - 1,
                                minlength=2)
        if not (np.array_equal(ids.cpu().numpy(), want_ids[rows])
                and np.array_equal(offs.cpu().numpy(), want_offs[rows])
                and np.array_equal(mhist.cpu().numpy(), want_hist)):
            raise AssertionError("sharded_map != map_reads")
        rec.update(table_keys=n, n_junction=n_junc, n_edge=n_edge,
                   mapped=int((want_ids != 0).sum()), n_map_reads=n_map)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(rec, f)
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

# the card's peaks (NVIDIA H100 SXM data sheet, at 700 W): HBM bytes/s, and
# the non-tensor float32 rate, against which the kernels' integer operations
# are counted (the data sheet gives no integer rate outside the tensor cores)
HBM_BYTES_S = 3.35e12
SCALAR_OPS_S = 67e12


def cuda_ms(fn, reps: int = 5) -> float:
    """Device time of one call of `fn`, from CUDA events around `reps`
    calls queued behind a sleep kernel, so that the host's launch cost does
    not show between them."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    if hasattr(torch.cuda, "_sleep"):
        torch.cuda._sleep(50_000_000)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over its
    memory rate and the operations over its scalar rate."""
    by_bytes = 1e3 * n_bytes / HBM_BYTES_S
    by_ops = 1e3 * n_ops / SCALAR_OPS_S
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": int(n_bytes), "operations": int(n_ops)}


def sm_clock_mhz(fn, call_ms: float, seconds: float = 0.5) -> float:
    """The SM clock (MHz) that nvidia-smi reads while `fn` runs: about
    `seconds` of calls are queued on the card first, so that the card is
    busy with them when the reading is taken."""
    import torch
    for _ in range(max(1, int(1e3 * seconds / max(call_ms, 1e-3)))):
        fn()
    res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True)
    torch.cuda.synchronize()
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return float(res.stdout.strip().splitlines()[0])


def with_share(rec: dict) -> dict:
    rec["roofline_share"] = rec["bound_ms"] / rec["ms"] if rec["ms"] else None
    return rec


def _mutate(rng, s, n_sub, n_ins, n_del):
    s = list(s)
    for _ in range(n_sub):
        i = rng.integers(0, len(s))
        s[i] = (s[i] + rng.integers(1, 4)) % 4
    for _ in range(n_ins):
        i = rng.integers(0, len(s) + 1)
        s.insert(i, rng.integers(0, 4))
    for _ in range(n_del):
        if s:
            del s[rng.integers(0, len(s))]
    return np.array(s, np.uint8)


def _pad(seqs, dev):
    import torch
    lens = np.array([len(s) for s in seqs], np.int32)
    mat = np.full((len(seqs), max(int(lens.max()), 1)), 4, np.uint8)
    for r, s in enumerate(seqs):
        mat[r, : len(s)] = s
    return torch.from_numpy(mat).to(dev), torch.from_numpy(lens).to(dev)


def _pair_set(rng, lengths, edits):
    qs, ts = [], []
    for i, n in enumerate(lengths):
        a = rng.integers(0, 4, size=int(n)).astype(np.uint8)
        b = _mutate(rng, a, *(int(rng.integers(0, e + 1)) for e in edits))
        if i % 17 == 3:
            a = a.copy()
            a[rng.integers(0, len(a), size=3)] = 4        # N codes
        qs.append(a)
        ts.append(b)
    qs[1] = np.zeros(0, np.uint8)                          # empty sides
    ts[2] = np.zeros(0, np.uint8)
    return qs, ts


# integer operations per evaluated cell or window, counted from the
# kernels' sources (compares, mins, adds, shifts, masks); they only decide
# whether the bound is set by operations or by bytes
ED_OPS_PER_CELL = 8
# segments in the largest of phase 8's edit_distance launches
# (smoke_expected.json, hybrid, segments_per_call)
HYBRID_SEGMENTS = 10_453
KMER_OPS_PER_WORD = 24
UNGAP_OPS_PER_BASE = 4
# per link scored: the window guard, two differences, four range compares,
# two mins, the gap and its absolute value, the table load, the conversion,
# the add and the subtract, the lane's compare and two selects
CHAIN_OPS_PER_LINK = 18
# chain_dp's serial chain: the cycles from f[i-1] to f[i] that no design
# can take off it (csrc/chain_dp.cu's head note), about 4 cycles for each
# dependent float32 operation: the add f[i-1] + gain(i, 1) (4), the
# subtract of cost(i, 1) (4), and the max with the best of the other
# candidates and kk (4), which is argmax's compare and select in one
CHAIN_CYCLES_PER_STEP = 4 + 4 + 4
# chain_dp's buckets (name, cap, groups, lookback, max_gap, k) at the
# shapes of phases 7 and 8: map-ont chunks of 256 long reads reach caps of
# 2048 (79 groups) and 4096 (24), the asm10 alignments of contigs against
# the genome cap 4096 (4 groups); at 1 Mbp phase 8 also runs cap 8192
# buckets of 3 to 8 groups and, where a whole assembly is aligned, one
# group at cap 2**17
CHAIN_SHAPES = [("map-ont_cap4096", 4096, 24, 25, 5000, 15),
                ("map-ont_cap2048", 2048, 79, 25, 5000, 15),
                ("asm10_cap4096", 4096, 4, 25, 10000, 19),
                ("map-ont_cap8192", 8192, 8, 25, 5000, 15),
                ("asm10_cap8192", 8192, 3, 25, 10000, 19),
                ("asm10_cap131072", 1 << 17, 2, 25, 10000, 19)]
# the plain version runs on the card at a shape only if the time a step it
# took on the smaller shapes puts it under this many seconds; past that it
# runs on a CPU copy of the same inputs
CHAIN_PLAIN_LIMIT_S = 30.0


def band_cells(qs, ts, bw: int) -> int:
    """Cells of the band that lie inside each pair's DP matrix (the work
    these pairs need): for each anti-diagonal d the band starts at
    lo(d) = max(d*ql // max(ql+tl-1, 1) - bw/2, 0) (csrc/edit_distance.cu)."""
    total = 0
    for q, t in zip(qs, ts):
        ql, tl = max(len(q), 1), max(len(t), 1)
        d = np.arange(ql + tl - 1, dtype=np.int64)
        lo = np.maximum(d * ql // max(ql + tl - 1, 1) - bw // 2, 0)
        first = np.maximum(lo, np.maximum(d - (tl - 1), 0))
        last = np.minimum(np.minimum(lo + bw - 1, d), ql - 1)
        total += int(np.maximum(last - first + 1, 0).sum())
    return total


def check_edit_distance(dev, rng):
    import torch

    from platanus_b_tpu_torch.ops import align
    from platanus_b_tpu_torch.ops.align import band_width, edit_distance_np
    results = []

    def run(name, qs, ts, bw, expect=None, timed=False):
        q, ql = _pad(qs, dev)
        t, tl = _pad(ts, dev)
        got = align.edit_distance(q, t, ql, tl, bw)
        want = align.edit_distance_plain(q, t, ql, tl, bw)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        check(err == 0, f"edit_distance {name}: kernel != plain (max err {err})")
        if expect is not None:
            g = got.cpu().numpy().tolist()
            check(expect(g), f"edit_distance {name}: unexpected values {g}")
        rec = {"set": name, "pairs": len(qs), "bw": bw, "max_abs_err": err}
        if timed:
            rec["ms"] = cuda_ms(lambda: align.edit_distance(q, t, ql, tl, bw),
                                reps=20)
            rec["plain_ms"] = cuda_ms(
                lambda: align.edit_distance_plain(q, t, ql, tl, bw), reps=2)
            cells = band_cells(qs, ts, bw)
            n_bytes = (q.numel() + t.numel() + 4 * (ql.numel() + tl.numel())
                       + 4 * len(qs))
            # the serial chain: the longest pair's dependent diagonals
            diagonals = max(max(len(x) + len(y) - 1, 0)
                            for x, y in zip(qs, ts))
            rec.update(band_cells=cells,
                       **bound(n_bytes, ED_OPS_PER_CELL * cells),
                       longest_pair_diagonals=diagonals,
                       ns_per_diagonal=1e6 * rec["ms"] / max(diagonals, 1))
            with_share(rec)
        results.append(rec)

    # the crush_bubble call of phase 4: 574 pairs of branch middles of at
    # most 133 bases, most of them one base long (SNP bubbles), full-cover
    # band (bw 384)
    lens = np.where(rng.random(574) < 0.9, 1, rng.integers(2, 134, size=574))
    lens[0] = 133
    qs, ts = _pair_set(rng, lens, (4, 3, 3))
    run("bubble", qs, ts, band_width(2 * max(len(s) for s in qs)), timed=True)
    # long-read segments (SEG_SPAN / SEG_BAND, longread.py:366-367)
    qs, ts = _pair_set(rng, rng.integers(1000, 1049, size=131), (20, 8, 8))
    run("segment", qs, ts, band_width(128), timed=True)
    # the phasing flow's launch in phase 7: asm10's segments (seg_span 256,
    # at most 303 bases) of haplotypes 0.3 % apart, at band 128
    qs, ts = _pair_set(rng, rng.integers(256, 304, size=3045), (2, 0, 0))
    run("phase_segments", qs, ts, band_width(128), timed=True)
    # phase 8's launches: map-ont segments (seg_span 1024, up to about
    # 1.1 kbp) of reads with 2 % errors, indels included, at band 128
    qs, ts = _pair_set(rng, rng.integers(900, 1101, size=HYBRID_SEGMENTS),
                       (11, 5, 5))
    run("hybrid_segments", qs, ts, band_width(128), timed=True)
    # one set per tier: each register tier (rows a lane 1..16), the band in
    # shared memory, the band in global scratch with rows read from global
    # memory, and rows too long to stage at a narrow band
    lens = [n for n in (20, 50, 100, 180, 250, 380, 470) for _ in range(2)]
    qs, ts = _pair_set(rng, np.array(lens), (6, 3, 3))
    run("register_tiers", qs, ts, band_width(512))
    qs, ts = _pair_set(rng, rng.integers(520, 1500, size=12), (12, 6, 6))
    run("shared_band", qs, ts, band_width(2048))
    qs, ts = _pair_set(rng, [19800, 19900, 300, 40], (40, 10, 10))
    run("global_band", qs, ts, band_width(20000))
    qs, ts = _pair_set(rng, [17000, 17300, 60], (30, 10, 10))
    run("unstaged", qs, ts, band_width(128))
    # the seven cases of tests/test_pallas_align.py
    r = np.random.default_rng(0)
    a = r.integers(0, 4, size=200, dtype=np.uint8)
    b = a.copy()
    b[50] = (b[50] + 1) % 4
    run("exact_and_simple", [a, a, a], [a, b, np.delete(a, 100)],
        band_width(64), lambda g: g == [0, 1, 1])
    r = np.random.default_rng(1)
    qs, ts = [], []
    for _ in range(13):
        n = int(r.integers(20, 150))
        x = r.integers(0, 4, size=n, dtype=np.uint8)
        qs.append(x)
        ts.append(_mutate(r, x, int(r.integers(0, 6)), int(r.integers(0, 3)),
                          int(r.integers(0, 3))))
    want = [edit_distance_np(x, y) for x, y in zip(qs, ts)]
    run("oracle", qs, ts, band_width(64), lambda g: g == want)
    r = np.random.default_rng(2)
    x = r.integers(0, 4, size=60, dtype=np.uint8)
    y = r.integers(0, 4, size=60, dtype=np.uint8)
    run("unrelated", [x], [y], band_width(128),
        lambda g: g == [edit_distance_np(x, y)])
    r = np.random.default_rng(3)
    x = r.integers(0, 4, size=300, dtype=np.uint8)
    run("length_skew", [x], [x[40:260]], band_width(192), lambda g: g == [80])
    run("n_codes", [np.full(30, 4, np.uint8)], [np.zeros(30, np.uint8)],
        band_width(64), lambda g: g == [30])
    e = np.zeros(0, np.uint8)
    f4 = np.arange(4, dtype=np.uint8) % 4
    run("empty", [e, f4, e], [f4, e, e], band_width(64),
        lambda g: g == [4, 4, 0])
    r = np.random.default_rng(4)
    x = r.integers(0, 4, size=400, dtype=np.uint8)
    y = np.concatenate([r.integers(0, 4, size=100, dtype=np.uint8), x])
    true = edit_distance_np(x, y)
    run("too_narrow", [x], [y], band_width(128), lambda g: g[0] >= true)
    return results


def check_kmer_extract(dev, rng, main_reads):
    import torch

    from platanus_b_tpu_torch.ops.kmer import (extract_kmers_packed,
                                               extract_kmers_packed_plain,
                                               pack_codes)
    results = []

    def compare(name, words, k, timed=False, **kw):
        got, gn = extract_kmers_packed(words, k, **kw)
        want, wn = extract_kmers_packed_plain(words, k, **kw)
        torch.cuda.synchronize()
        same = torch.equal(got, want) and torch.equal(gn, wn)
        check(same, f"kmer_extract {name} k={k}: kernel != plain")
        windows = int(got.shape[0] * got.shape[1])
        rec = {"set": name, "k": k, "windows": windows, "max_abs_err": 0}
        if timed:
            rec["ms"] = cuda_ms(lambda: extract_kmers_packed(words, k, **kw),
                                reps=20)
            rec["plain_ms"] = cuda_ms(
                lambda: extract_kmers_packed_plain(words, k, **kw), reps=2)
            # each input read once (packed words, N-mask or lengths), each
            # output written once (the keys and n_valid)
            n_in = sum(x.numel() * x.element_size()
                       for x in (words, kw.get("nmask"), kw.get("lengths"))
                       if x is not None)
            n_out = got.numel() * got.element_size() + 8
            W = -(-k // 16)
            rec.update(mode="nmask" if "nmask" in kw else "lengths",
                       **bound(n_in + n_out, KMER_OPS_PER_WORD * W * windows))
            with_share(rec)
        results.append(rec)

    R, L = 1500, 160
    codes = rng.integers(0, 4, size=(R, L)).astype(np.uint8)
    lens = rng.integers(90, L + 1, size=R).astype(np.int32)
    codes[np.arange(L)[None, :] >= lens[:, None]] = 4
    with_n = codes.copy()
    with_n[rng.random((R, L)) < 0.002] = 4
    c_t = torch.from_numpy(codes).to(dev)
    n_t = torch.from_numpy(with_n).to(dev)
    l_t = torch.from_numpy(lens).to(dev)
    w_plain, _ = pack_codes(c_t)
    w_n, m_n = pack_codes(n_t)
    for k in (16, 25, 32, 33, 42, 52, 62, 64, 65, 72, 95):
        compare("nmask", w_n, k, nmask=m_n, max_len=L)
        compare("lengths", w_plain, k, lengths=l_t, max_len=int(lens.max()))
    compare("forward", w_n, 42, nmask=m_n, max_len=L, forward_only=True)
    # rows longer than a whole-read tile (a concatenated contig set)
    long_codes = rng.integers(0, 4, size=(2, 20000)).astype(np.uint8)
    long_codes[rng.random(long_codes.shape) < 0.001] = 4
    w_l, m_l = pack_codes(torch.from_numpy(long_codes).to(dev))
    for k in (32, 65):
        compare("long_rows", w_l, k, nmask=m_l, max_len=19990)
    # the main path's shape: every read of the run's dataset at k = 32,
    # packed and validated as the first counting pass does it
    words, nmask = main_reads.packed()
    mode = ({"nmask": nmask} if main_reads.has_n
            else {"lengths": main_reads.lengths})
    compare("main_path", words, 32, timed=True, max_len=main_reads.max_len,
            **mode)
    return results


def ungap_bound(args) -> dict:
    """Bytes these inputs need: the read codes and lengths, every slot's ok
    flag, the metadata (is_fwd, cid, ro, clen: 13 bytes) of the ok slots
    and of slot 0 where it is not ok (its values are returned when nothing
    scores), starts and the contig pool once each, and the five outputs;
    operations: a few per base compared in each ok slot's span. Beside it,
    the figure with every input read whole."""
    codes, lengths, pool, starts, ok = args[:5]
    R, L = codes.shape
    n_slots = ok.numel()
    ok_slots = int(ok.sum())
    slot0_not_ok = int((~ok.reshape(R, -1)[:, 0]).sum()) if R else 0
    common = (codes.numel() + 4 * R + pool.numel() + 4 * starts.numel()
              + 5 * 4 * R)
    need = common + n_slots + 13 * (ok_slots + slot0_not_ok)
    rec = bound(need, UNGAP_OPS_PER_BASE * L * ok_slots)
    all_inputs = common + 14 * n_slots
    rec.update(ok_slots=ok_slots, slot0_not_ok=slot0_not_ok,
               all_inputs_bytes=all_inputs,
               all_inputs_bound_ms=1e3 * all_inputs / HBM_BYTES_S)
    return rec


def check_ungap_align(dev, data: str):
    """ungap_align against its plain version on all five outputs, exactly:
    timed at the main path's shape (the round's forward reads against the
    scaffold's index, as polish maps them: S = 5, H = 16, min_identity 0),
    then on the edge sets of simulate.ungap_edge_inputs."""
    import torch

    from platanus_b_tpu_torch.commands.libparse import (LibrarySpec,
                                                        load_pair_library)
    from platanus_b_tpu_torch.models import mapper
    from platanus_b_tpu_torch.simulate import ungap_edge_inputs
    results = []

    def compare(name, args, timed=False, **extra):
        got = mapper.ungap_align(*args)
        want = mapper.ungap_align_plain(*args)
        torch.cuda.synchronize()
        err = max(float((g.double() - w.double()).abs().max()) if len(g) else 0.0
                  for g, w in zip(got, want))
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        check(same, f"ungap_align {name}: kernel != plain (max err {err})")
        rec = {"set": name, "reads": int(args[0].shape[0]),
               "slots": int(args[4].shape[1] * args[4].shape[2]),
               "width": int(args[0].shape[1]),
               "mapped": int((got[0] != 0).sum()), "max_abs_err": err, **extra}
        if timed:
            rec["ms"] = cuda_ms(lambda: mapper.ungap_align(*args), reps=20)
            rec["plain_ms"] = cuda_ms(lambda: mapper.ungap_align_plain(*args),
                                      reps=2)
            rec.update(ungap_bound(args))
            with_share(rec)
        results.append(rec)

    lib = load_pair_library(LibrarySpec(1, [("IP", [os.path.join(data, "r1.fa"),
                                                    os.path.join(data, "r2.fa")])]))
    lut = np.full(256, 4, np.uint8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)
    contigs = [lut[np.frombuffer(x.encode(), np.uint8)]
               for x in read_fasta(os.path.join(data, "scaffold.fa"))]
    index = mapper.ContigIndex(contigs, key_length=32, device=dev)
    codes = torch.from_numpy(lib.fwd_codes).to(dev)
    lens = torch.from_numpy(lib.fwd_lengths).to(dev)
    S = -(-codes.shape[1] // 32) + 1
    cand = mapper.ungap_candidates(index, codes, lens, 32, S,
                                   mapper.MAX_CANDIDATES)
    compare("main_path", (codes, lens, index.pool_t, index.starts_t, *cand,
                          0.0), timed=True)
    del cand
    for seed, width, mi in ((1, 100, 0.0), (2, 100, 0.97), (3, 150, 0.9),
                            (4, 300, 0.5), (5, 600, 0.9)):
        arrs = ungap_edge_inputs(seed, width=width, min_identity=mi)
        args = [torch.from_numpy(a).to(dev) for a in arrs[:-1]] + [arrs[-1]]
        compare(f"edge_{seed}_w{width}", args, min_identity=mi)
    # dedup before scoring: all-equal slots, not-ok slots ahead of their ok
    # twins, S*H = 21 (no multiple of 32)
    for seed, width, mi, S, H in ((7, 100, 0.0, 5, 16), (8, 100, 0.97, 3, 7),
                                  (9, 600, 0.9, 5, 16)):
        arrs = ungap_edge_inputs(seed, width=width, min_identity=mi, S=S,
                                 H=H, twins=True)
        args = [torch.from_numpy(a).to(dev) for a in arrs[:-1]] + [arrs[-1]]
        compare(f"twins_{seed}_w{width}_sh{S * H}", args, min_identity=mi)
    return results


def check_chain_dp(dev):
    """chain_dp against its plain version at CHAIN_SHAPES, f (as uint32)
    and prev bit for bit, on simulate.chain_dp_inputs' groups (cap/2 + 1 to
    cap anchors each): the kernel timed over 20 launches, the plain version
    once (about 20 eager launches a step, so its own wall is the host's),
    on the card or, where that would pass CHAIN_PLAIN_LIMIT_S, on a CPU
    copy of the inputs."""
    import torch

    from platanus_b_tpu_torch.ops import chain
    from platanus_b_tpu_torch.simulate import chain_dp_inputs
    results = []
    plain_s_per_step = 0.0
    for name, cap, B, H, max_gap, kk in CHAIN_SHAPES:
        qs, ts, ns = chain_dp_inputs(cap, B, cap, max_gap, edges=False)
        q, t, n = (torch.from_numpy(x).to(dev) for x in (qs, ts, ns))
        table = chain.gap_cost_table(max_gap, dev)
        steps = int(ns.max()) - 1
        rec = {"set": name, "cap": cap, "groups": B, "lookback": H,
               "max_gap": max_gap, "k": kk, "longest_group_steps": steps}
        f, prev = chain.chain_dp(q, t, n, H, max_gap, kk)
        torch.cuda.synchronize()
        estimate = plain_s_per_step * (cap - 1)
        if estimate <= CHAIN_PLAIN_LIMIT_S:
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            wf, wp = chain.chain_dp_plain(q, t, n, H, max_gap, kk, table)
            t1.record()
            torch.cuda.synchronize()
            rec["plain_ms"] = t0.elapsed_time(t1)
            plain_s_per_step = max(plain_s_per_step,
                                   rec["plain_ms"] / 1e3 / (cap - 1))
        else:
            cpu = torch.device("cpu")
            t0 = time.perf_counter()
            wf, wp = chain.chain_dp_plain(
                *(torch.from_numpy(x) for x in (qs, ts, ns)), H, max_gap, kk,
                chain.gap_cost_table(max_gap, cpu))
            rec.update(plain_ms=None, plain_estimate_s=estimate,
                       plain_cpu_s=time.perf_counter() - t0)
            f, prev = f.cpu(), prev.cpu()
        same = (torch.equal(f.view(torch.int32), wf.view(torch.int32))
                and torch.equal(prev, wp))
        err = max(float((f.double() - wf.double()).abs().max()),
                  float((prev - wp).abs().max()))
        check(same, f"chain_dp {name}: kernel != plain (max err {err})")
        rec.update(max_abs_err=err, linked=int((wp >= 0).sum()))
        rec["ms"] = cuda_ms(lambda: chain.chain_dp(q, t, n, H, max_gap, kk),
                            reps=20 if cap <= 4096 else 5)
        n_bytes = 4 * (q.numel() + t.numel() + n.numel() + table.numel()
                       + 2 * q.numel())
        # links a group scores: min(i, H) at step i = 1 .. n-1
        m = np.maximum(ns.astype(np.int64) - 1, 0)
        links = int(np.where(m <= H, m * (m + 1) // 2,
                             H * (H + 1) // 2 + (m - H) * H).sum())
        rec.update(**bound(n_bytes, CHAIN_OPS_PER_LINK * links),
                   ns_per_step=1e6 * rec["ms"] / max(steps, 1))
        # the second bound: the longest group's serial chain at the SM
        # clock the card ran the kernel at
        mhz = sm_clock_mhz(lambda: chain.chain_dp(q, t, n, H, max_gap, kk),
                           rec["ms"])
        rec.update(sm_clock_mhz=mhz, chain_bound_ms=(
            steps * CHAIN_CYCLES_PER_STEP / (mhz * 1e3)))
        rec["chain_share"] = rec["chain_bound_ms"] / rec["ms"]
        results.append(with_share(rec))
    return results


# K5 and K6: the graph layer's device loops, at the shapes the main path
# gives them (inputs recorded in phases 3 and 5) and on a synthetic
# labeling of the same size whose one junction-free cycle holds half of
# the oriented ids, as a clean circular chromosome's two strands do

LINK_MEAN_CHAIN = 300


@contextlib.contextmanager
def record_calls(module, name: str, size=None):
    """module.<name> wrapped for the block; yields a list that receives
    each call's arguments (tensors cloned). With `size`, the list holds
    only the call of the largest size(args) so far, the first of equal
    ones; a call whose size is negative is never kept."""
    import torch
    orig = getattr(module, name)
    calls: list = []
    best = [-1]

    def wrapper(*args):
        key = size(args) if size is not None else 0
        if size is None or key > best[0]:
            kept = tuple(a.clone() if isinstance(a, torch.Tensor) else a
                         for a in args)
            if size is None:
                calls.append(kept)
            else:
                best[0] = key
                calls[:] = [kept]
        return orig(*args)

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


def _max_err(got, want) -> int:
    return max((int((g - w).abs().max()) if g.numel() else 0)
               for g, w in zip(got, want))


def check_list_rank(dev, main_call, label: str):
    """list_rank against its plain version: the first doubling pass of the
    main path's largest labeling (`main_call`, recorded in phase 3), then
    the two passes and the min-pair loop of a synthetic labeling of the
    same m whose cycle holds half of the ids (simulate.label_links). ptr,
    rank, anchor, the min pairs, the steps that did work and the live flag
    bit for bit; the kernel timed over 5 calls, the plain version over 2."""
    import torch

    from platanus_b_tpu_torch.models import dbg
    from platanus_b_tpu_torch.ops import rank
    from platanus_b_tpu_torch.simulate import label_links
    m, iters = main_call[0].shape[0], main_call[1]
    nxt = torch.from_numpy(label_links(5, m // 2, 0.5,
                                       LINK_MEAN_CHAIN)).to(dev)
    with record_calls(dbg, "rank_from_prev") as passes, \
            record_calls(dbg, "cycle_min_pair") as pairs:
        dbg._rank_chains(nxt, iters)
    check(len(passes) == 2 and len(pairs) == 1,
          "the half-cycle labeling did not cut its cycle")
    sets = [(label, main_call), ("half_cycle_pass1", passes[0]),
            ("half_cycle_min_pair", pairs[0]), ("half_cycle_pass2", passes[1])]
    results = []
    for name, args in sets:
        rec = {"set": name, "m": m, "iters": iters}
        if name.endswith("min_pair"):
            kernel = lambda args=args: rank.cycle_min_pair(*args)
            plain = lambda args=args: rank.cycle_min_pair_plain(*args)
            got, want = kernel(), plain()
            same = all(torch.equal(g, w) for g, w in zip(got, want))
            steps = iters
            # ptr, a, b read once; a, b written once
            n_bytes, n_ops = 40 * m, 3 * iters * m
        else:
            kernel = lambda args=args: rank.rank_from_prev(*args)
            plain = lambda args=args: rank.rank_from_prev_plain(*args)
            got, want = kernel(), plain()
            steps = want[3]
            live = int((want[0] >= 0).any())
            same = (all(torch.equal(g, w) for g, w in zip(got[:3], want[:3]))
                    and got[3].tolist() == [steps, live])
            rec["live_after"] = live
            # prv read once; ptr, rank, anchor written once; an add and a
            # compare an id a step
            n_bytes, n_ops = 32 * m, 2 * steps * m
        torch.cuda.synchronize()
        err = _max_err(got[:3], want[:3])
        check(same, f"list_rank {name}: kernel != plain (max err {err})")
        rec.update(steps_that_worked=steps, max_abs_err=err,
                   ms=cuda_ms(kernel), plain_ms=cuda_ms(plain, reps=2),
                   **bound(n_bytes, n_ops))
        rec["ns_per_step"] = 1e6 * rec["ms"] / max(steps, 1)
        results.append(with_share(rec))
    return results


def check_lex_search(dev, sets):
    """lex_search against its plain version on recorded calls: `sets` is
    a list of (name, mode, args), mode "lookup" (the wrapper's lookup;
    args table, queries) or "range" (lookup_range; args table, queries,
    table_len). Outputs bit for bit; the kernel timed over 20 calls, the
    plain version over 2. At one lane, beside them, the library calls:
    lookup's torch.searchsorted alone and with the equality gather (the
    plain version's whole function), lookup_range's two searchsorted calls
    (left and right) on the live rows."""
    import torch

    from platanus_b_tpu_torch.ops import search
    results = []
    for name, mode, args in sets:
        table, queries = args[0], args[1]
        n = int(args[2]) if len(args) > 2 and args[2] is not None \
            else table.shape[0]
        M, L = queries.shape
        rec = {"set": name, "mode": mode, "rows": n,
               "capacity": table.shape[0], "queries": M, "lanes": L}
        library = {}
        col = table[:n, 0].contiguous()
        qcol = queries[:, 0].contiguous()
        if mode == "range":
            kernel = lambda: search.lookup_range(table, queries, n)
            plain = lambda: search.lookup_range_plain(table, queries, n)
            outs = 2
            if L == 1:
                library["searchsorted_left_right"] = lambda: (
                    torch.searchsorted(col, qcol),
                    torch.searchsorted(col, qcol, right=True))
        else:
            outs = 1
            kernel = lambda: (search.lookup(table, queries, n),)
            plain = lambda: (search.lookup_plain(table, queries, n),)
            if L == 1:
                library["searchsorted"] = lambda: torch.searchsorted(col,
                                                                     qcol)
                library["searchsorted_gather"] = plain
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = _max_err(got, want)
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"lex_search {name}: kernel != plain (max err {err})")
        steps = search._steps(table.shape[0] if mode == "range" else n)
        # the table's live rows and the queries read once, the outputs
        # written once; a compare a lane a step
        rec.update(max_abs_err=err, steps=steps, ms=cuda_ms(kernel, reps=20),
                   plain_ms=cuda_ms(plain, reps=2),
                   library_ms={key: cuda_ms(fn, reps=20)
                               for key, fn in library.items()} or None,
                   found=int((want[0] >= 0).sum()) if outs == 1 else None,
                   **bound(8 * (L * (n + M) + outs * M),
                           outs * steps * L * M))
        results.append(with_share(rec))
    return results


# K7: one unitig of 300,000 nodes with counts 60-99 summing to 23,849,980
# (simulate.coverage_counts seed 0), whose float32 sum in node order gives
# ucov 80 where the exact sum gives 79
LONG_UNITIG = {"seed": 0, "nodes": 300_000, "lo": 60, "hi": 99,
               "total": 23_849_980}
# K7's long path under stress, at phase 3's 4.6 Mbp labeling shape:
# 5,754,499 nodes, 64,267 unitigs, 12 of them of 250-450 k nodes (counts
# 60-99, sums above 2^24), the node ids shuffled so that every unitig
# spreads over the whole array (simulate.interleaved_unitigs). No run
# has shown so many: see FINAL_100X.
MANY_LONG = {"seed": 12, "nodes": 5_754_499, "unitigs": 64_267, "long": 12,
             "long_lo": 250_000, "long_hi": 450_000, "lo": 60, "hi": 99}
# K7's long path as runs give it: of the 27 K7 calls of `assemble -k 32`
# on this script's reads at 4.6 Mbp and 100x, only the final rebuild's
# labeling has unitigs past 2^24 (none at 40x; unitig_sum_in_turns.py's
# survey): 4,599,887 nodes in 22 unitigs, two of them of 694,221 and
# 612,372 nodes, whose nodes' counts run 24-37 (1st-99th percentile
# 27-31, mean 29.07). Here: the two lengths drawn from that range, the
# other 20 unitigs sharing the rest, ids shuffled, counts 27-31.
FINAL_100X = {"seed": 100, "nodes": 4_599_887, "unitigs": 22, "long": 2,
              "long_lo": 612_372, "long_hi": 694_221, "lo": 27, "hi": 31}
# K7's walk: a step (up to 32 chunks) waits on k for the select of the
# composed increment by k's parity, the add, the binade test, the ballot
# and the shuffle of the new k, at 4 cycles each at least (the warp scan
# that composes the chunks does not wait on k); the parent's design
# (22515a4) added each value after the tile of 4,096 ids where the exact
# sum passed 2^24 with one __fadd_rn (4 cycles) on one thread
UNITIG_WALK_CYCLES_PER_STEP = 5 * 4
UNITIG_ADD_CYCLES = 4
PARENT_TILE = 4096


def host_ms(fn, reps: int = 2) -> float:
    """Host wall of one call of `fn`, which runs on the host alone."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return 1e3 * (time.perf_counter() - t0) / reps


def parent_serial_adds(uid_h: np.ndarray, counts_h: np.ndarray,
                       long_ids) -> int:
    """The longest chain of one-at-a-time float adds in the parent's K7
    (one block a long unitig, in parallel): the values of a long unitig
    from the first tile of PARENT_TILE ids where its exact sum would pass
    2^24."""
    most = 0
    for u in long_ids:
        ids = np.flatnonzero(uid_h == u)
        first = ids[np.argmax(np.cumsum(counts_h[ids]) > (1 << 24))]
        tile_start = (first // PARENT_TILE) * PARENT_TILE
        most = max(most, int((ids >= tile_start).sum()))
    return most


def check_unitig_sum(dev, main_call, label: str):
    """unitig_sum against its plain version (numpy's float32 add.at on the
    host, from CPU copies made once): the count sums of the main path's
    largest labeling (`main_call`, recorded in phase 3, ulen included),
    LONG_UNITIG, MANY_LONG and FINAL_100X, the sums bit for bit and ulen
    against the exact node counts; the kernel timed over 20 calls, the
    plain version over 2 on the host clock, index_add_ in float32 on the
    card (atomics in no fixed order: the same sum, not the same rounding)
    as the library call. The bound counts uid and counts read once and the
    sums and ulen written once. A long set also reports its walk from the kernel's stats
    (long unitigs, chunks, chunks replayed, the longest walk's steps) and
    two estimates, modelled and not measured, which stay off the kernels
    line: the walk's serial bound, the longest walk's steps times
    UNITIG_WALK_CYCLES_PER_STEP over the SM clock nvidia-smi reads while
    the kernel runs, and beside it the parent design's serial chain
    (parent_serial_adds times UNITIG_ADD_CYCLES over the same clock)."""
    import torch

    from platanus_b_tpu_torch import kernels
    from platanus_b_tpu_torch.models import dbg
    from platanus_b_tpu_torch.simulate import (coverage_counts,
                                               interleaved_unitigs)
    lu = LONG_UNITIG
    long_counts = torch.from_numpy(coverage_counts(
        lu["seed"], lu["nodes"], lu["lo"], lu["hi"], lu["total"])).to(dev)

    def interleaved(cfg):
        uid, counts = interleaved_unitigs(
            cfg["seed"], cfg["nodes"], cfg["unitigs"], cfg["long"],
            cfg["long_lo"], cfg["long_hi"], cfg["lo"], cfg["hi"])
        return (torch.from_numpy(uid).to(dev),
                torch.from_numpy(counts).to(dev), cfg["unitigs"])

    sets = [(label, main_call[:3]),
            ("long_unitig_300k", (torch.zeros(lu["nodes"], dtype=torch.int64,
                                              device=dev), long_counts, 1)),
            ("many_long", interleaved(MANY_LONG)),
            ("final_100x", interleaved(FINAL_100X))]
    results = []
    for name, (uid, counts, num_u) in sets:
        counts = counts.to(torch.int64)
        uid_h, counts_h = uid.cpu(), counts.cpu()
        kernel = lambda: dbg.unitig_count_sums(uid, counts, num_u, True)
        plain = lambda: dbg.unitig_count_sums_plain(uid_h, counts_h, num_u)
        slot = torch.where(uid >= 0, uid, num_u)
        counts_f = counts.to(torch.float32)
        library = lambda: torch.zeros(num_u + 1, device=dev).index_add_(
            0, slot, counts_f)
        (got, ulen), want = kernel(), plain()
        torch.cuda.synchronize()
        err = float((got.cpu() - want).abs().max()) if num_u else 0.0
        check(torch.equal(got.cpu(), want),
              f"unitig_sum {name}: kernel != plain (max err {err})")
        check(torch.equal(ulen, dbg._per_unitig_sum(
                  uid, torch.ones_like(uid), num_u)),
              f"unitig_sum {name}: ulen != the node counts")
        exact = dbg._per_unitig_sum(uid, counts, num_u)
        n = uid.shape[0]
        rec = {"set": name, "nodes": n, "unitigs": num_u,
               "long_unitigs": int((exact >= (1 << 24)).sum()),
               "max_abs_err": err, "ms": cuda_ms(kernel, reps=20),
               "plain_ms": host_ms(plain), "library_ms": cuda_ms(library,
                                                                 reps=20),
               **bound(16 * n + 12 * num_u, n)}
        if rec["long_unitigs"]:
            stats = torch.zeros(4, dtype=torch.int64, device=dev)
            kernels.unitig_sum(uid, counts, num_u, torch.empty_like(got),
                               None, stats)
            n_long, chunks, replays, steps = stats.tolist()
            check(n_long == rec["long_unitigs"],
                  f"unitig_sum {name}: {n_long} long unitigs walked")
            mhz = sm_clock_mhz(kernel, rec["ms"])
            serial = parent_serial_adds(
                uid_h.numpy(), counts_h.numpy(),
                np.flatnonzero(exact.cpu().numpy() > (1 << 24)))
            rec.update(chunks=chunks, chunks_replayed=replays,
                       walk_steps=steps, sm_clock_mhz=mhz,
                       walk_bound_estimate_ms=steps
                       * UNITIG_WALK_CYCLES_PER_STEP / (1e3 * mhz),
                       parent_serial_adds=serial,
                       parent_serial_estimate_ms=serial * UNITIG_ADD_CYCLES
                       / (1e3 * mhz))
        if name.startswith("long"):
            ulen_f = float(n)
            rec["ucov"] = int(torch.floor(got / ulen_f + 0.5)[0])
            rec["ucov_exact_sum"] = int(torch.floor(
                exact.to(torch.float32) / ulen_f + 0.5)[0])
            check((rec["ucov"], rec["ucov_exact_sum"]) == (80, 79),
                  f"unitig_sum {name}: ucov {rec['ucov']}, exact "
                  f"{rec['ucov_exact_sum']} (want 80, 79)")
        results.append(with_share(rec))
    return results


def load_main_reads(path: str, dev):
    """The main run's reads staged on the card as assemble stages them."""
    from platanus_b_tpu_torch.models.assemble_core import stage_read_files
    return stage_read_files([path], dev)


# ---------------------------------------------------------------------------
# phases 3-5: the main path through the CLI
# ---------------------------------------------------------------------------

def reset_launches() -> None:
    from platanus_b_tpu_torch import kernels
    for key in kernels.LAUNCHES:
        kernels.LAUNCHES[key] = 0


def top_device_ms(prof) -> dict:
    """The five largest kernels and copies by name in a torch.profiler
    run, by their summed card time (ms)."""
    from torch.autograd import DeviceType
    by_name = {}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0))
            name = evt.key.split("(")[0].split("<")[0].strip()[:60]
            by_name[name] = by_name.get(name, 0.0) + us / 1000.0
    return dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:5])


def run_cli(argv: list[str], record: dict | None = None,
            profile: bool = False) -> int:
    """One command through the port's CLI; a non-zero exit fails the run.
    With `record`, adds the command's wall, launches, stage times and peak
    device memory under its name; with `profile`, also its five largest
    kernels and copies by card time from torch.profiler (the wall then
    includes the profiler's start-up and overhead)."""
    import contextlib

    import torch

    from platanus_b_tpu_torch import kernels
    from platanus_b_tpu_torch.commands.main import main as cli_main
    from platanus_b_tpu_torch.utils.log import LOG
    LOG.reset()
    before = dict(kernels.LAUNCHES)
    torch.cuda.reset_peak_memory_stats()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    ctx = (torch.profiler.profile(activities=acts) if profile
           else contextlib.nullcontext())
    t0 = time.perf_counter()
    with ctx as prof:
        rc = cli_main(argv)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(rc == 0, f"{' '.join(argv)} exited {rc}")
    if record is not None:
        rec = {"wall_s": wall, "stage_s": dict(LOG.timings),
               "launches": {k: kernels.LAUNCHES[k] - before[k] for k in before},
               "peak_device_gib": torch.cuda.max_memory_allocated() / (1 << 30)}
        if profile:
            rec["top_device_ms"] = top_device_ms(prof)
        record[argv[0]] = rec
    return rc


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--genome-bp", type=int, default=1_000_000,
                    help="parity dataset of phase 3: 1000000 or 4600000")
    args = ap.parse_args()

    PHASE["name"] = "environment"
    try:
        import torch
    except ImportError as e:
        fail(f"missing dependency: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: chip_smoke needs a CUDA card")
    try:
        import platanus_b_tpu_torch  # noqa: F401
        from platanus_b_tpu_torch import kernels
        from platanus_b_tpu_torch.simulate import (simulate_reads,
                                                   simulate_two_haplotypes)
    except ImportError as e:
        fail(f"platanus_b_tpu_torch not importable ({e}); run from the repo root")

    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    kernels.library()
    build_s = time.perf_counter() - t0
    ptxas = ptxas_summary(kernels.BUILD_INFO.get("log", ""))
    emit({"phase": "environment", "ok": True, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "kernel_build_s": build_s,
          "kernel_library_compiled": kernels.BUILD_INFO.get("compiled"),
          "ptxas": ptxas})

    work = os.path.join(REPO, "platanus_b_tpu_torch", "build", "smoke")
    os.makedirs(work, exist_ok=True)
    with open(os.path.join(REPO, "platanus_b_tpu_torch",
                           "smoke_expected.json")) as f:
        exp = json.load(f)
    check("round" in exp, "smoke_expected.json has no round record")
    gbp = args.genome_bp
    reads_fa = os.path.join(work, f"reads_{gbp}.fa")
    t0 = time.perf_counter()
    simulate_reads(reads_fa, gbp, 125, 40, 0.003, 123)
    round_data = os.path.join(work, "round_data")
    inputs = make_round_dataset(round_data, ROUND_DATASET)
    emit({"phase": "datasets", "ok": True, "seconds": time.perf_counter() - t0,
          "round_inputs_sha256": inputs})
    check(ROUND_DATASET == exp["round"]["dataset"]
          and inputs == exp["round"]["inputs_sha256"],
          "the round dataset differs from the one smoke_expected.json was "
          "made from")

    kern = {"edit_distance": {"name": "edit_distance", "route": "cuda",
                              "source": "platanus_b_tpu_torch/csrc/edit_distance.cu",
                              "replaces": "platanus_b_tpu/ops/pallas_align.py:43"},
            "kmer_extract": {"name": "kmer_extract", "route": "cuda",
                             "source": "platanus_b_tpu_torch/csrc/kmer_extract.cu",
                             "replaces": "platanus_b_tpu/ops/kmer.py:25"},
            "ungap_align": {"name": "ungap_align", "route": "cuda",
                            "source": "platanus_b_tpu_torch/csrc/ungap_align.cu",
                            "replaces": "platanus_b_tpu/models/mapper.py:374"},
            "chain_dp": {"name": "chain_dp", "route": "cuda",
                         "source": "platanus_b_tpu_torch/csrc/chain_dp.cu",
                         "replaces": "platanus_b_tpu/models/longread.py:31"},
            "list_rank": {"name": "list_rank", "route": "cuda",
                          "source": "platanus_b_tpu_torch/csrc/list_rank.cu",
                          "replaces": "platanus_b_tpu/models/dbg.py:191"},
            "lex_search": {"name": "lex_search", "route": "cuda",
                           "source": "platanus_b_tpu_torch/csrc/lex_search.cu",
                           "replaces": "platanus_b_tpu/ops/search.py:26"},
            "unitig_sum": {"name": "unitig_sum", "route": "cuda",
                           "source": "platanus_b_tpu_torch/csrc/unitig_sum.cu",
                           "replaces": "platanus_b_tpu/models/dbg.py:338"}}
    PHASE["name"] = "kernels"
    rng = np.random.default_rng(2024)
    ed = check_edit_distance(dev, rng)
    km = check_kmer_extract(dev, rng, load_main_reads(reads_fa, dev))
    ua = check_ungap_align(dev, round_data)
    cd = check_chain_dp(dev)
    emit({"phase": "kernels", "ok": True, "edit_distance": ed,
          "kmer_extract": km, "ungap_align": ua, "chain_dp": cd})
    for name, recs in (("edit_distance", ed), ("kmer_extract", km),
                       ("ungap_align", ua), ("chain_dp", cd)):
        timed = [r for r in recs if "ms" in r][0]
        # no single PyTorch call computes any of the four functions
        kern[name].update(max_abs_err=max(r["max_abs_err"] for r in recs
                                          if r["max_abs_err"] is not None),
                          ms=timed["ms"], plain_ms=timed["plain_ms"],
                          bound_ms=timed["bound_ms"],
                          bound_by=timed["bound_by"], library_ms=None,
                          roofline_share=timed["roofline_share"],
                          timed_set=timed["set"])
    # chain_dp's second bound, its serial chain (phase 2)
    kern["chain_dp"].update({key: cd[0][key] for key in (
        "ns_per_step", "chain_bound_ms", "chain_share", "sm_clock_mhz")})
    torch.cuda.empty_cache()
    launches = {}

    # ---- phase 3: the main path at the parity scale, recording the
    # inputs of its largest labeling and lookups for K5 and K6
    PHASE["name"] = "main_path"
    from platanus_b_tpu_torch.models import dbg as dbg_mod
    reset_launches()
    prefix = os.path.join(work, f"out_{gbp}")
    steps: dict = {}
    with record_calls(dbg_mod, "rank_from_prev",
                      lambda a: a[0].shape[0]) as rank_call, \
            record_calls(dbg_mod, "unitig_count_sums",
                         lambda a: a[0].shape[0]) as sum_call, \
            record_calls(dbg_mod, "lookup", lambda a: a[0].shape[0]
                         if a[0].shape[1] > 1 else -1) as adj_call, \
            record_calls(dbg_mod, "lookup", lambda a: a[0].shape[0]
                         if a[0].shape[1] == 1 else -1) as l1_call:
        run_cli(["assemble", "-f", reads_fa, "-k", "32", "-o", prefix], steps)
    launches["main_path"] = dict(kernels.LAUNCHES)
    seqs = read_fasta(prefix + "_contig.fa")
    got = sorted_set_sha256(seqs)
    ref_path = os.path.join(REPO, "parity", f"PARITY_assemble_{gbp}.json")
    rec = {"phase": "main_path", "genome_bp": gbp,
           "wall_s": steps["assemble"]["wall_s"],
           "num_seqs": len(seqs), "sorted_set_sha256": got,
           "launches": launches["main_path"],
           "stage_s": steps["assemble"]["stage_s"],
           "peak_device_gib": steps["assemble"]["peak_device_gib"]}
    if os.path.exists(ref_path):
        with open(ref_path) as f:
            ref = json.load(f)["platanus_b_tpu"]
        rec.update(expected_sha256=ref["sorted_set_sha256"],
                   expected_num_seqs=ref["num_seqs"])
        rec["ok"] = (got == ref["sorted_set_sha256"]
                     and len(seqs) == ref["num_seqs"])
    else:
        rec["ok"] = False
        rec["error"] = f"no parity record {os.path.relpath(ref_path, REPO)}"
    emit(rec)
    check(rec["ok"], "contig set differs from the parity record")
    for name in ("kmer_extract", "list_rank", "lex_search", "unitig_sum"):
        check(launches["main_path"][name] > 0, f"{name} never launched")
    main_wall, parity_sha = rec["wall_s"], rec["expected_sha256"]

    # K5 and K6 against their plain versions at phase 3's shapes (phase 2's
    # format; launches here do not count)
    PHASE["name"] = "graph_kernels"
    check(rank_call and adj_call and l1_call and sum_call,
          "phase 3 recorded no labeling, lookup or count sums")
    lr = check_list_rank(dev, rank_call[0], f"labeling_{gbp}")
    lx = check_lex_search(dev, [("adjacency_lanes", "lookup", adj_call[0]),
                                ("adjacency_k32_l1", "lookup", l1_call[0])])
    us = check_unitig_sum(dev, sum_call[0], f"labeling_{gbp}")
    del rank_call[:], adj_call[:], l1_call[:], sum_call[:]
    emit({"phase": "graph_kernels", "ok": True, "list_rank": lr,
          "lex_search": lx, "unitig_sum": us})
    # no single PyTorch call ranks a list; none searches keys of several
    # lanes (the one-lane row holds torch.searchsorted's times, alone and
    # with the equality gather)
    kern["list_rank"].update(
        max_abs_err=max(r["max_abs_err"] for r in lr), library_ms=None,
        **{key: lr[0][key] for key in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "roofline_share",
                                       "steps_that_worked", "ns_per_step")},
        timed_set=lr[0]["set"])
    kern["lex_search"].update(
        max_abs_err=max(r["max_abs_err"] for r in lx), library_ms=None,
        **{key: lx[0][key] for key in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "roofline_share")},
        timed_set=lx[0]["set"], l1_ms=lx[1]["ms"],
        l1_library_ms=lx[1]["library_ms"])
    kern["unitig_sum"].update(
        max_abs_err=max(r["max_abs_err"] for r in us),
        **{key: us[0][key] for key in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "roofline_share",
                                       "library_ms")},
        timed_set=us[0]["set"],
        **{f"{key}_{field}": rec[field]
           for key, rec in (("long_unitig", us[1]), ("many_long", us[2]),
                            ("final_100x", us[3]))
           for field in ("ms", "plain_ms", "library_ms", "walk_steps",
                         "chunks_replayed")})
    torch.cuda.empty_cache()

    # ---- phase 4: the bubble configuration
    PHASE["name"] = "bubble"
    ds = exp["dataset"]
    bub_fa = os.path.join(work, "bubble_reads.fa")
    simulate_two_haplotypes(bub_fa, ds["genome_bp"], ds["het_rate"],
                            ds["read_len"], ds["coverage_each"],
                            ds["error"], ds["seed"])
    bprefix = os.path.join(work, "bubble")
    reset_launches()
    steps = {}
    run_cli(["assemble", "-f", bub_fa, "-o", bprefix] + exp["flags"], steps)
    launches["bubble"] = dict(kernels.LAUNCHES)
    hashes = {name: file_sha256(f"{bprefix}_{name}") for name in exp["sha256"]}
    ok = hashes == exp["sha256"]
    bubble_bytes = os.path.getsize(f"{bprefix}_contigBubble.fa") \
        if os.path.exists(f"{bprefix}_contigBubble.fa") else 0
    emit({"phase": "bubble", "ok": ok, "wall_s": steps["assemble"]["wall_s"],
          "sha256": hashes, "expected_sha256": exp["sha256"],
          "contigBubble_bytes": bubble_bytes, "launches": launches["bubble"],
          "stage_s": steps["assemble"]["stage_s"],
          "peak_device_gib": steps["assemble"]["peak_device_gib"]})
    check(ok, "bubble-configuration outputs differ from smoke_expected.json")
    check(bubble_bytes > 0, "no bubble was crushed")
    check(launches["bubble"]["edit_distance"] > 0, "edit_distance never launched")

    # ---- phase 5: an iterate round without solve_dbg
    PHASE["name"] = "round"
    rexp = exp["round"]
    round_work = os.path.join(work, "round")
    shutil.rmtree(round_work, ignore_errors=True)
    torch.cuda.empty_cache()
    reset_launches()
    steps = {}
    from platanus_b_tpu_torch.models import mapper as mapper_mod
    range_call: list = []

    def round_step(argv):
        """One command of the round; polish records its largest
        lookup_range for K6."""
        if argv[0] != "polish":
            return run_cli(argv, steps)
        with record_calls(mapper_mod, "lookup_range",
                          lambda a: a[1].shape[0]) as calls:
            rc = run_cli(argv, steps)
        range_call.extend(calls)
        return rc

    run_round(round_work, round_data, round_step)
    launches["round"] = dict(kernels.LAUNCHES)
    hashes = round_hashes(round_work)
    ok = hashes == rexp["sha256"]
    emit({"phase": "round", "ok": ok, "sha256": hashes,
          "expected_sha256": rexp["sha256"], "launches": launches["round"],
          "steps": steps, "jax_cpu_wall_s": rexp.get("jax_cpu_wall_s")})
    check(ok, "round outputs differ from smoke_expected.json")
    for name in ("kmer_extract", "ungap_align", "lex_search"):
        check(launches["round"][name] > 0, f"{name} never launched in the round")
    PHASE["name"] = "mapper_kernels"
    check(len(range_call) == 1, "polish recorded no lookup_range")
    lm = check_lex_search(dev, [("polish_index", "range", range_call[0])])
    del range_call[:]
    emit({"phase": "mapper_kernels", "ok": True, "lex_search": lm})
    kern["lex_search"].update(range_ms=lm[0]["ms"],
                              range_plain_ms=lm[0]["plain_ms"],
                              range_library_ms=lm[0]["library_ms"],
                              max_abs_err=max(kern["lex_search"]["max_abs_err"],
                                              lm[0]["max_abs_err"]))
    PHASE["name"] = "round"
    # the round once more under torch.profiler: each command's largest
    # kernels and copies
    prof_work = os.path.join(work, "round_profiled")
    shutil.rmtree(prof_work, ignore_errors=True)
    occ_wall = steps["assemble"]["wall_s"]
    steps = {}
    run_round(prof_work, round_data,
              lambda argv: run_cli(argv, steps, profile=True))
    check(round_hashes(prof_work) == rexp["sha256"],
          "profiled round outputs differ from smoke_expected.json")
    emit({"phase": "round_profiled", "ok": True, "steps": steps})

    # ---- phase 6: a whole `iterate -i 1`
    PHASE["name"] = "iterate"
    iexp = exp.get("iterate")
    check(iexp is not None, "smoke_expected.json has no iterate record")
    contigs_sha = make_iterate_contigs(round_data, ROUND_DATASET)
    check(ROUND_DATASET == iexp["dataset"]
          and contigs_sha == iexp["contigs_sha256"]
          and ITERATE_ARGV == iexp["argv"],
          "the iterate input differs from the one smoke_expected.json was "
          "made from")
    it_work = os.path.join(work, "iterate")
    shutil.rmtree(it_work, ignore_errors=True)
    torch.cuda.empty_cache()
    reset_launches()
    steps = {}
    run_iterate(it_work, round_data, lambda argv: run_cli(argv, steps))
    launches["iterate"] = dict(kernels.LAUNCHES)
    hashes = iterate_hashes(it_work)
    it1 = os.path.join(it_work, "it_iterateIntermediateResults", "it1")
    n_div = fasta_count(os.path.join(it1, "it_kmerDivided.fa"))
    n_cons = fasta_count(os.path.join(it1, "it_consensusScaffold.fa"))
    rec = steps["iterate"]
    stage_walls = {k[len("iterate: "):]: v for k, v in rec["stage_s"].items()
                   if k.startswith("iterate: ")}
    ok = hashes == iexp["sha256"]
    emit({"phase": "iterate", "ok": ok, "wall_s": rec["wall_s"],
          "stage_walls_s": stage_walls, "peak_device_gib":
          rec["peak_device_gib"], "launches": launches["iterate"],
          "num_kmer_divided": n_div, "num_consensus_scaffolds": n_cons,
          "sha256": hashes, "expected_sha256": iexp["sha256"],
          "jax_cpu_wall_s": iexp.get("jax_cpu_wall_s")})
    check(ok, "iterate outputs differ from smoke_expected.json")
    for name in ("kmer_extract", "ungap_align"):
        check(launches["iterate"][name] > 0,
              f"{name} never launched in iterate")
    check(n_cons < n_div, "solve_dbg joined no contigs")
    # its solve_dbg -unphase stage once more under torch.profiler, on the
    # same input: its largest kernels and copies
    stage = "solve_dbg -unphase (round 1)"
    os.makedirs(os.path.join(it_work, "prof"), exist_ok=True)
    prof_steps = {}
    cwd = os.getcwd()
    os.chdir(it_work)
    try:
        run_cli(["solve_dbg", "-unphase", "-reduce_redundancy", "-c",
                 "it_iterateIntermediateResults/it1/it_kmerDivided.fa",
                 "-u", "0.0", "-o", "prof/it", "-IP1", "r1.fa", "r2.fa"],
                prof_steps, profile=True)
    finally:
        os.chdir(cwd)
    check(file_sha256(os.path.join(it_work, "prof", "it_consensusScaffold.fa"))
          == iexp["sha256"]["it_iterateIntermediateResults/it1/"
                            "it_consensusScaffold.fa"],
          "profiled solve_dbg output differs from smoke_expected.json")
    emit({"phase": "iterate_profiled", "ok": True, "stage": stage,
          "solve_dbg": prof_steps["solve_dbg"]})

    # ---- phase 7: the phasing flow (the default solve_dbg)
    PHASE["name"] = "phasing"
    pexp = exp.get("phasing")
    check(pexp is not None, "smoke_expected.json has no phasing record")
    ph_work = os.path.join(work, "phasing")
    shutil.rmtree(ph_work, ignore_errors=True)
    contigs_sha = make_phasing_contigs(ph_work, PHASING_DATASET)
    check(PHASING_DATASET == pexp["dataset"]
          and contigs_sha == pexp["contigs_sha256"]
          and PHASING_ARGV == pexp["argv"],
          "the phasing input differs from the one smoke_expected.json was "
          "made from")
    # the segments each K1 call verifies, and the walls of the aligner's
    # parts (its align_batch is the haplotig alignment)
    segments, walls, buckets = [], {}, []
    torch.cuda.empty_cache()
    reset_launches()
    steps = {}
    with aligner_split(walls, segments, buckets):
        run_phasing(ph_work, lambda argv: run_cli(argv, steps))
    launches["phasing"] = dict(kernels.LAUNCHES)
    hashes = phasing_hashes(ph_work)
    rec = steps["solve_dbg"]
    ok = hashes == pexp["sha256"]
    emit({"phase": "phasing", "ok": ok, "wall_s": rec["wall_s"],
          "stage_walls_s": walls, "peak_device_gib": rec["peak_device_gib"],
          "launches": launches["phasing"],
          "segments": [n for n, _ in segments],
          "longest_pair_diagonals": max((m for _, m in segments), default=0),
          "chain_buckets": len(buckets),
          "largest_buckets": sorted(buckets, reverse=True)[:8],
          "sha256": hashes, "expected_sha256": pexp["sha256"],
          "jax_cpu_wall_s": pexp.get("jax_cpu_wall_s")})
    check(ok, "phasing outputs differ from smoke_expected.json")
    for name in ("edit_distance", "kmer_extract", "chain_dp"):
        check(launches["phasing"][name] > 0,
              f"{name} never launched in the phasing flow")

    # ---- phase 8: the hybrid iterate (long reads, two rounds, a combine)
    PHASE["name"] = "hybrid"
    hexp = exp.get("hybrid")
    check(hexp is not None, "smoke_expected.json has no hybrid record")
    hy_work = os.path.join(work, "hybrid")
    shutil.rmtree(hy_work, ignore_errors=True)
    t0 = time.perf_counter()
    inputs = make_hybrid_dataset(hy_work, HYBRID_DATASET)
    data_s = time.perf_counter() - t0
    check(HYBRID_DATASET == hexp["dataset"]
          and inputs == hexp["inputs_sha256"] and HYBRID_ARGV == hexp["argv"],
          "the hybrid input differs from the one smoke_expected.json was "
          "made from")
    segments, walls, buckets = [], {}, []
    torch.cuda.empty_cache()
    reset_launches()
    steps = {}
    with aligner_split(walls, segments, buckets):
        run_from(hy_work, HYBRID_ARGV, lambda argv: run_cli(argv, steps))
    launches["hybrid"] = dict(kernels.LAUNCHES)
    hashes = iterate_hashes(hy_work, "hy")
    rec = steps["iterate"]
    stage_walls = {k[len("iterate: "):]: v for k, v in rec["stage_s"].items()
                   if k.startswith("iterate: ")}
    ok = hashes == hexp["sha256"]
    emit({"phase": "hybrid", "ok": ok, "wall_s": rec["wall_s"],
          "dataset_s": data_s, "stage_walls_s": stage_walls,
          "aligner_walls_s": walls, "peak_device_gib": rec["peak_device_gib"],
          "launches": launches["hybrid"],
          "edit_distance_calls": [n for n, _ in segments],
          "segments": sum(n for n, _ in segments),
          "longest_pair_diagonals": max((m for _, m in segments), default=0),
          "chain_buckets": len(buckets),
          "chain_groups": sum(b for _, b in buckets),
          "largest_buckets": sorted(buckets, reverse=True)[:8],
          "num_output_seqs": fasta_count(os.path.join(
              hy_work, "hy_iterativeAssembly.fa")),
          "sha256": hashes, "expected_sha256": hexp["sha256"],
          "jax_cpu_wall_s": hexp.get("jax_cpu_wall_s")})
    check(ok, "hybrid outputs differ from smoke_expected.json")
    for name in ("edit_distance", "kmer_extract", "ungap_align", "chain_dp"):
        check(launches["hybrid"][name] > 0,
              f"{name} never launched in the hybrid iterate")

    # ---- phase 9: the multi-process layer, two ranks sharing the card
    PHASE["name"] = "multi_process"
    t_phase = time.perf_counter()
    mp_work = os.path.join(work, "multi_process")
    occ_work = os.path.join(mp_work, "round")
    dl_work = os.path.join(mp_work, "device_layer")
    shutil.rmtree(mp_work, ignore_errors=True)
    for d in (occ_work, dl_work):
        os.makedirs(d)
    split_records(reads_fa, os.path.join(mp_work, "a.fa"),
                  os.path.join(mp_work, "b.fa"))
    for name in ("r1.fa", "r2.fa"):
        shutil.copy(os.path.join(round_data, name), os.path.join(occ_work, name))
    torch.cuda.empty_cache()
    # (a) assemble on phase 3's reads as two files, one for each rank
    run_a = torchrun(MP_ASSEMBLE_ARGV, mp_work, MP_RANKS)
    mp_sha = sorted_set_sha256(read_fasta(os.path.join(mp_work,
                                                       "mp_contig.fa")))
    single = sorted(f[len(f"out_{gbp}_"):] for f in os.listdir(work)
                    if f.startswith(f"out_{gbp}_"))
    multi = sorted(f[len("mp_"):] for f in os.listdir(mp_work)
                   if f.startswith("mp_"))
    same_files = multi == single and all(
        file_sha256(os.path.join(mp_work, f"mp_{f}"))
        == file_sha256(os.path.join(work, f"out_{gbp}_{f}")) for f in single)
    rank1_quiet = ("[default1]:assemble completed (non-zero host, no output)!"
                   in run_a["log"])
    # (b) the round's -kmer_occ_only count on its reads
    run_b = torchrun(MP_OCC_ARGV, occ_work, MP_RANKS)
    occ_hashes = {f"occ_{name}": file_sha256(os.path.join(occ_work,
                                                          f"mpocc_{name}"))
                  for name in ("62merFrq.tsv", "kmer_occ.bin")}
    occ_expected = {name: rexp["sha256"][name] for name in occ_hashes}
    # (c) the device layer over NCCL, one rank for each card
    import torch.multiprocessing as tmp
    world = torch.cuda.device_count()
    tmp.spawn(device_layer_rank, nprocs=world, join=True,
                                args=(world, free_port(), reads_fa, dl_work))
    ranks_c = []
    for r in range(world):
        with open(os.path.join(dl_work, f"rank{r}.json")) as f:
            ranks_c.append(json.load(f))
    runs = [rep["kernel_launches"] for run in (run_a, run_b)
            for rep in run["reports"]] + [rc["launches"] for rc in ranks_c]
    launches["multi_process"] = {name: sum(r[name] for r in runs)
                                 for name in kernels.LAUNCHES}

    def per_rank(run, key):
        return [rep[key] for rep in run["reports"]]

    def run_record(run, argv, single_wall):
        """The walls (launch to exit; each rank from its logger's start to
        its report, and its top-level stages), peaks and launches."""
        return {"argv": argv, "wall_launch_to_exit_s": run["wall_s"],
                "single_process_wall_s": single_wall,
                "rank_since_start_s": per_rank(run, "since_start_s"),
                "rank_stage_s": [{k: v for k, v in rep["stage_s"].items()
                                  if not k.startswith(" ")}
                                 for rep in run["reports"]],
                "peak_device_bytes_by_rank": per_rank(
                    run, "peak_allocated_bytes"),
                "launches_by_rank": per_rank(run, "kernel_launches")}

    ok = (mp_sha == parity_sha and same_files and rank1_quiet
          and occ_hashes == occ_expected)
    emit({"phase": "multi_process", "ok": ok, "ranks": MP_RANKS,
          "wall_s": time.perf_counter() - t_phase,
          "assemble": {**run_record(run_a, MP_ASSEMBLE_ARGV, main_wall),
                       "sorted_set_sha256": mp_sha,
                       "expected_sha256": parity_sha,
                       "files": multi, "files_equal_phase3": same_files,
                       "rank1_wrote_nothing": rank1_quiet},
          "kmer_occ": {**run_record(run_b, MP_OCC_ARGV, occ_wall),
                       "sha256": occ_hashes, "expected_sha256": occ_expected},
          "device_layer": {"world": world, "map_shape": MP_MAP,
                           "ranks": ranks_c},
          "launches": launches["multi_process"]})
    check(ok, "the multi-process runs differ from the single-process ones")
    for name, run in (("assemble", run_a), ("-kmer_occ_only", run_b)):
        check(all(rep["kernel_launches"]["kmer_extract"] > 0
                  for rep in run["reports"]),
              f"kmer_extract never launched on a rank of {name}")
    check(all(rc["launches"]["kmer_extract"] > 0 for rc in ranks_c),
          "kmer_extract never launched in sharded_count")

    PHASE["name"] = "summary"
    for name, entry in kern.items():
        entry["launches"] = sum(ph[name] for ph in launches.values())
        entry["launches_by_phase"] = {p: ph[name] for p, ph in launches.items()}
        check(entry["launches"] > 0, f"{name} never launched on the main path")
    emit({"kernels": list(kern.values())})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
