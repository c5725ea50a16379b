"""Seeded read simulators for the smoke run and its expected outputs.

numpy only, so the JAX package and the port can be fed identical files.

- ``simulate_reads``: the dataset of parity/run_parity.py:121 (`simulate`):
  a uniform random genome, fixed-length reads from both strands, uniform
  substitution errors. With (1_000_000, 125, 40, 0.003, 123) it is the
  dataset of parity/PARITY_assemble_1000000.json.
- ``simulate_two_haplotypes``: a genome plus a second haplotype carrying
  substitutions at `het_rate` (every mutated base changes, the model of
  tests/simdata.py:mutate), reads drawn from each haplotype as above; it
  makes the bubbles that `assemble -u` crushes.
- ``simulate_phase_contigs``: the contig set of the phasing flow's test
  (tests/test_phase.py:50-57) at bacterial scale: a homozygous contig and
  two haplotypes of one heterozygous region, the second carrying
  substitutions at `het_rate`, headed with coverages 40, 21 and 19.
- ``simulate_long_reads``: long reads from both strands of a genome, with
  lengths drawn from an exponential distribution and substitutions,
  insertions and deletions at given rates (an ONT-like read set);
- ``simulate_fragmented_contigs``: a genome cut into contigs of a length
  range with the stretches between them dropped and every other contig
  reverse-complemented, headed as `assemble` heads its contigs: the shape
  of a short-read assembly broken at repeats;
- ``ungap_edge_inputs``: inputs of the ungap_align kernel that reach its
  edge cases (reads shorter than a seed, N codes, slots at contig ends in
  both orientations, duplicate slots across seeds, tied maxima, and with
  ``twins`` all-equal slots and not-ok slots ahead of their ok twins);
- ``chain_dp_inputs``: anchor groups for the chaining DP that are hard for
  a warp's reduction (exact ties between lookback offsets, duplicate
  anchors, no ok link at all) beside indel-like groups;
- ``label_links``: the chain links of a unitig labeling, linear chains
  with their strand mirrors and, at will, one junction-free cycle holding
  a given share of the nodes, as a circular chromosome makes it;
- ``search_inputs``: a sorted key table padded with SENTINEL rows and
  queries that reach the search's edge cases (no live row, a full table,
  duplicate runs, queries above the last row and equal to the SENTINEL).
"""

from __future__ import annotations

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _sample_reads(rng, garr: np.ndarray, read_len: int, coverage: float,
                  error: float) -> np.ndarray:
    genome_size = len(garr)
    n_reads = genome_size * int(coverage) // read_len
    starts = rng.integers(0, genome_size - read_len, size=n_reads)
    reads = garr[starts[:, None] + np.arange(read_len)[None, :]]
    flip = rng.random(n_reads) < 0.5
    reads[flip] = 3 - reads[flip, ::-1]
    mask = rng.random(reads.shape) < error
    reads[mask] = (reads[mask] + rng.integers(1, 4, size=int(mask.sum()))) % 4
    return reads


def _write_fasta(path: str, reads: np.ndarray) -> None:
    rows = _BASES[reads]
    with open(path, "w") as f:
        f.write("".join(f">r{i}\n{rows[i].tobytes().decode()}\n"
                        for i in range(len(rows))))


def simulate_reads(path: str, genome_size: int, read_len: int,
                   coverage: float, error: float, seed: int) -> str:
    """Write reads.fa at `path` (run_parity.simulate's exact random draws);
    returns the genome as ACGT text."""
    rng = np.random.default_rng(seed)
    garr = rng.integers(0, 4, size=genome_size, dtype=np.uint8)
    _write_fasta(path, _sample_reads(rng, garr, read_len, coverage, error))
    return _BASES[garr].tobytes().decode()


def simulate_two_haplotypes(path: str, genome_size: int, het_rate: float,
                            read_len: int, coverage_each: float, error: float,
                            seed: int) -> tuple[str, str]:
    """Write reads of two haplotypes (coverage_each from each) at `path`;
    returns both haplotypes as ACGT text."""
    rng = np.random.default_rng(seed)
    h1 = rng.integers(0, 4, size=genome_size, dtype=np.uint8)
    h2 = h1.copy()
    snp = rng.random(genome_size) < het_rate
    h2[snp] = (h2[snp] + rng.integers(1, 4, size=int(snp.sum()))) % 4
    r1 = _sample_reads(rng, h1, read_len, coverage_each, error)
    r2 = _sample_reads(rng, h2, read_len, coverage_each, error)
    _write_fasta(path, np.concatenate([r1, r2]))
    return (_BASES[h1].tobytes().decode(), _BASES[h2].tobytes().decode())


def simulate_phase_contigs(path: str, homo_bp: int, hap_bp: int,
                           het_rate: float, seed: int) -> None:
    """Write contigs.fa at `path` for `solve_dbg -c` (its default phasing
    flow): seq1 homozygous (cov40), seq2 haplotype 1 (cov21), seq3
    haplotype 1 with substitutions at `het_rate` (cov19), one line each."""
    rng = np.random.default_rng(seed)
    homo = rng.integers(0, 4, size=homo_bp, dtype=np.uint8)
    h1 = rng.integers(0, 4, size=hap_bp, dtype=np.uint8)
    h2 = h1.copy()
    snp = rng.random(hap_bp) < het_rate
    h2[snp] = (h2[snp] + rng.integers(1, 4, size=int(snp.sum()))) % 4
    with open(path, "w") as f:
        for i, (seq, cov) in enumerate(((homo, 40), (h1, 21), (h2, 19)),
                                       start=1):
            f.write(f">seq{i}_len{len(seq)}_cov{cov}_read100_maxK50\n"
                    f"{_BASES[seq].tobytes().decode()}\n")


def _codes(genome: str) -> np.ndarray:
    lut = np.full(256, 4, np.uint8)
    lut[_BASES] = np.arange(4, dtype=np.uint8)
    return lut[np.frombuffer(genome.encode(), np.uint8)]


def simulate_long_reads(path: str, genome: str, coverage: float,
                        mean_len: int, sub: float, ins: float, dele: float,
                        seed: int, min_len: int = 1000) -> int:
    """Write long reads of `genome` (ACGT text) at `path` (FASTA, ont{i}):
    genome * coverage / mean_len reads, each of length max(min_len,
    Exponential(mean_len)) (at most the genome) from a uniform start, from
    either strand. Each base of the read's span is independently deleted
    (rate `dele`), substituted by another base (rate `sub`) or preceded by
    an inserted random base (rate `ins`). Returns the number of reads."""
    rng = np.random.default_rng(seed)
    garr = _codes(genome)
    n = max(1, int(len(garr) * coverage / mean_len))
    with open(path, "w") as f:
        for i in range(n):
            ln = min(max(min_len, int(rng.exponential(mean_len))), len(garr))
            st = int(rng.integers(0, len(garr) - ln + 1))
            r = garr[st: st + ln].copy()
            if rng.random() < 0.5:
                r = 3 - r[::-1]
            u = rng.random(ln)
            is_sub = u < sub
            is_ins = (u >= sub) & (u < sub + ins)
            is_del = (u >= sub + ins) & (u < sub + ins + dele)
            r[is_sub] = (r[is_sub] + rng.integers(1, 4, size=int(is_sub.sum()))) % 4
            # each kept base emits itself, after a random base where inserted
            reps = np.where(is_del, 0, np.where(is_ins, 2, 1))
            out = np.repeat(r, reps)
            first = np.cumsum(reps) - reps
            out[first[is_ins]] = rng.integers(0, 4, size=int(is_ins.sum()))
            f.write(f">ont{i}\n{_BASES[out].tobytes().decode()}\n")
    return n


def simulate_fragmented_contigs(path: str, genome: str, min_len: int,
                                max_len: int, min_gap: int, max_gap: int,
                                seed: int, read_len: int = 125,
                                max_k: int = 63) -> int:
    """Write `genome` (ACGT text) cut into contigs at `path`: lengths
    uniform in [min_len, max_len], a stretch of uniform [min_gap, max_gap]
    bases dropped after each, every other contig reverse-complemented,
    headed seq{i}_len{L}_cov40_read{read_len}_maxK{max_k}, 80 bases a line.
    Returns the number of contigs."""
    rng = np.random.default_rng(seed)
    garr = _codes(genome)
    pos, i = 0, 0
    with open(path, "w") as f:
        while pos < len(garr):
            ln = int(rng.integers(min_len, max_len + 1))
            c = garr[pos: pos + ln]
            if i % 2:
                c = 3 - c[::-1]
            text = _BASES[c].tobytes().decode()
            i += 1
            f.write(f">seq{i}_len{len(c)}_cov40_read{read_len}_maxK{max_k}\n")
            f.write("".join(text[j: j + 80] + "\n"
                            for j in range(0, len(text), 80)))
            pos += ln + int(rng.integers(min_gap, max_gap + 1))
    return i


def ungap_edge_inputs(seed: int, n_reads: int = 600, width: int = 100,
                      S: int = 5, H: int = 16, min_identity: float = 0.9,
                      twins: bool = False):
    """numpy inputs of models/mapper.py:ungap_align, in its argument order:
    (codes (R, L) u8, lengths (R,) i32, pool (cap,) u8, starts (C+1,) i32,
    ok, is_fwd (R, S, H) bool, cid, ro, clen (R, S, H) i32, min_identity).

    Contig 1 repeats contig 0, so a slot on each at the same offset ties.
    Each read is cut from a contig at an offset that may overhang either
    end, in either orientation, with substitutions and Ns; its slots hold
    the true placement, near misses, copies of earlier slots (duplicates
    across seeds) and random placements, some of them not ok.

    `twins` adds, from a second generator so the rest stays as it is, the
    slot patterns that dedup before scoring must get right: reads whose
    every slot is the true placement (all ok, or ok from slot 7 or 14 on),
    and reads whose true placement sits first in a slot that is not ok,
    with an ok twin later."""
    rng = np.random.default_rng(seed)
    clens = rng.integers(40, 400, size=8)
    clens[1] = clens[0]
    contigs = [rng.integers(0, 4, size=int(n), dtype=np.uint8) for n in clens]
    contigs[1] = contigs[0].copy()
    contigs[3][rng.random(clens[3]) < 0.05] = 4
    starts = np.zeros(len(contigs) + 1, np.int32)
    np.cumsum(clens, out=starts[1:])
    cap = 64
    while cap < starts[-1]:
        cap <<= 1
    pool = np.full(cap, 4, np.uint8)
    pool[: starts[-1]] = np.concatenate(contigs)

    R, L = n_reads, width
    codes = np.full((R, L), 4, np.uint8)
    lengths = rng.integers(1, L + 1, size=R).astype(np.int32)
    lengths[rng.random(R) < 0.5] = L
    shape = (R, S, H)
    ok = rng.random(shape) < 0.15
    is_fwd = rng.random(shape) < 0.5
    cid = rng.integers(0, len(contigs), size=shape).astype(np.int32)
    ro = np.zeros(shape, np.int32)
    for r in range(R):
        c = int(rng.integers(0, len(contigs)))
        fwd = bool(rng.random() < 0.5)
        n = int(clens[c])
        o = int(rng.integers(-L // 2, n + L // 2))
        p = np.arange(L)
        coord = o + p if fwd else o - p
        inside = (coord >= 0) & (coord < n)
        base = rng.integers(0, 4, size=L).astype(np.uint8)
        cb = contigs[c][np.clip(coord, 0, n - 1)]
        base[inside] = cb[inside] if fwd else 3 ^ np.minimum(cb[inside], 3)
        sub = rng.random(L) < 0.03
        base[sub] = (base[sub] + 1) % 4
        base[rng.random(L) < 0.01] = 4
        codes[r, : lengths[r]] = base[: lengths[r]]
        ro[r] = o + rng.integers(-40, 41, size=(S, H))
        is_fwd[r, 0, 0], cid[r, 0, 0], ro[r, 0, 0], ok[r, 0, 0] = fwd, c, o, True
        if rng.random() < 0.3:             # the same alignment from a later seed
            s2, h2 = int(rng.integers(1, S)), int(rng.integers(0, H))
            is_fwd[r, s2, h2], cid[r, s2, h2], ro[r, s2, h2] = fwd, c, o
            ok[r, s2, h2] = True
        if c in (0, 1) and rng.random() < 0.5:   # a tie on the twin contig
            s2, h2 = int(rng.integers(0, S)), int(rng.integers(1, H))
            is_fwd[r, s2, h2], cid[r, s2, h2], ro[r, s2, h2] = fwd, 1 - c, o
            ok[r, s2, h2] = True
    if twins:
        tw = np.random.default_rng(seed + 1000)
        for r in range(R):
            kind = r % 4
            if kind == 1:                    # every slot equal
                is_fwd[r] = is_fwd[r, 0, 0]
                cid[r], ro[r] = cid[r, 0, 0], ro[r, 0, 0]
                ok[r] = np.arange(S * H).reshape(S, H) >= tw.integers(0, 3) * 7
            elif kind == 2:                  # a not-ok twin ahead of its ok one
                ok[r, 0, 0] = False
                s2, h2 = int(tw.integers(0, S)), int(tw.integers(1, H))
                is_fwd[r, s2, h2] = is_fwd[r, 0, 0]
                cid[r, s2, h2], ro[r, s2, h2] = cid[r, 0, 0], ro[r, 0, 0]
                ok[r, s2, h2] = True
    clen = clens[cid].astype(np.int32)
    return (codes, lengths, pool, starts, ok, is_fwd, cid, ro, clen,
            float(min_identity))


def chain_dp_inputs(seed: int, B: int, cap: int, max_gap: int,
                    edges: bool = True):
    """numpy inputs of ops/chain.py:chain_dp: (q, t (B, cap) int32, n (B,)
    int32), each group sorted by (t, q) as _collect_groups sorts it, zero
    past n. Rows cycle through four patterns:
    - diagonal runs of steps dq = dt of 1-3 bases: along a run f grows by
      the step, so every offset h with h * step <= kk scores the same and
      the nearest j must win;
    - anchors repeated up to four times: equal (q, t) anchors tie exactly;
    - steps of 1-60 bases with indel-sized differences between dq and dt,
      and now and then a jump of thousands of bases;
    - steps above max_gap, so that no link is ok.
    With `edges` the first three rows hold 0, 1 and cap anchors; the
    others hold cap/2 + 1 to cap. Positions stay below 2**31 for cap up to
    2**17."""
    rng = np.random.default_rng(seed)
    qs = np.zeros((B, cap), np.int32)
    ts = np.zeros((B, cap), np.int32)
    ns = np.zeros(B, np.int32)
    for b in range(B):
        n = int(rng.integers(cap // 2 + 1, cap + 1))
        if edges and b < 3:
            n = (0, 1, cap)[b]
        kind = b % 4
        if kind == 0:
            dq = rng.choice([1, 1, 1, 2, 3], size=n)
            dt = dq.copy()
            brk = rng.random(n) < 0.02
            dt[brk] += rng.integers(-40, 41, size=int(brk.sum()))
        elif kind == 1:
            run = np.repeat(np.arange(n), rng.integers(1, 5, size=n))[:n]
            fresh = np.r_[True, run[1:] != run[:-1]]
            dq = np.where(fresh, rng.integers(1, 40, size=n), 0)
            dt = dq.copy()
        elif kind == 2:
            dq = rng.integers(1, 60, size=n)
            dt = dq + rng.integers(-8, 9, size=n) * (rng.random(n) < 0.5)
            jump = rng.random(n) < 0.05
            dt[jump] += rng.integers(-3000, 3000, size=int(jump.sum()))
        else:
            dq = rng.integers(max_gap + 1, max_gap + 100, size=n)
            dt = dq + rng.integers(-5, 6, size=n)
        q = 100 + np.cumsum(dq)
        t = 100 + np.cumsum(np.maximum(dt, 0))
        order = np.lexsort((q, t))
        qs[b, :n], ts[b, :n], ns[b] = q[order], t[order], n
    return qs, ts, ns


def label_links(seed: int, n_nodes: int, cycle_share: float = 0.0,
                mean_chain: int = 40) -> np.ndarray:
    """The chain links of a unitig labeling (models/dbg.py:_label_core's
    nxt): (2 n_nodes,) int64 over oriented ids 2i+o, -1 for no link, each
    link x -> y present with its strand mirror y^1 -> x^1. Nodes in random
    order and orientation form linear chains of geometric lengths (mean
    `mean_chain`; a tenth of the nodes stand alone, as junctions and dead
    nodes do). With `cycle_share` > 0, one junction-free cycle holds that
    share of the nodes first, so that its two strands hold that share of
    the oriented ids, as a clean circular chromosome's do."""
    rng = np.random.default_rng(seed)
    nxt = np.full(2 * n_nodes, -1, np.int64)
    order = rng.permutation(n_nodes).astype(np.int64)
    orient = rng.integers(0, 2, size=n_nodes)

    def link(u, v):
        x, y = 2 * u + orient[u], 2 * v + orient[v]
        nxt[x] = y
        nxt[y ^ 1] = x ^ 1

    c = int(round(cycle_share * n_nodes))
    if c:
        link(order[:c], np.roll(order[:c], -1))
    rest = order[c:]
    if len(rest) > 1:
        joined = rng.random(len(rest) - 1) >= 1.0 / mean_chain
        alone = rng.random(len(rest)) < 0.1
        joined &= ~alone[:-1] & ~alone[1:]
        link(rest[:-1][joined], rest[1:][joined])
    return nxt


def coverage_counts(seed: int, n: int, lo: int, hi: int,
                    total: int | None = None) -> np.ndarray:
    """(n,) int64 node counts drawn uniformly from [lo, hi]. With `total`,
    the first counts are moved towards it, each as far as [lo, hi] lets
    it, until the counts sum to `total` (the per-unitig sums above 2^24
    that models/dbg.py:unitig_count_sums must round as float32 does)."""
    rng = np.random.default_rng(seed)
    c = rng.integers(lo, hi + 1, size=n).astype(np.int64)
    if total is not None:
        d = int(total) - int(c.sum())
        room = (hi - c) if d > 0 else (c - lo)
        before = np.cumsum(room) - room
        c += np.sign(d) * np.minimum(room, np.maximum(abs(d) - before, 0))
        if int(c.sum()) != total:
            raise ValueError(f"{n} counts in [{lo}, {hi}] cannot sum to "
                             f"{total}")
    return c


def interleaved_unitigs(seed: int, nodes: int, unitigs: int, n_long: int,
                        long_lo: int, long_hi: int, lo: int,
                        hi: int) -> tuple[np.ndarray, np.ndarray]:
    """(uid, counts), both (nodes,) int64: `n_long` unitigs of
    [long_lo, long_hi] nodes each, the other unitigs sharing the remaining
    nodes (at least one each), the nodes in random order (so every unitig
    is spread over the whole array, as node ids in sorted k-mer order
    spread a real unitig) and counts drawn uniformly from [lo, hi]."""
    rng = np.random.default_rng(seed)
    long_len = rng.integers(long_lo, long_hi + 1, size=n_long)
    short = unitigs - n_long
    rest = nodes - int(long_len.sum()) - short
    if short < 0 or rest < 0:
        raise ValueError(f"{nodes} nodes cannot fill {unitigs} unitigs")
    lens = np.concatenate([long_len, 1 + rng.multinomial(
        rest, np.full(short, 1.0 / short)) if short else []])
    ids = rng.permutation(unitigs)
    uid = rng.permutation(np.repeat(ids, lens.astype(np.int64)))
    counts = rng.integers(lo, hi + 1, size=nodes)
    return uid.astype(np.int64), counts.astype(np.int64)


def _key_words(rng, rows: int, W: int, alphabet: int) -> np.ndarray:
    """(rows, W) uint32 words, each word one of `alphabet` values spread
    over the range; the top word is halved, so no row is the SENTINEL."""
    w = rng.integers(0, alphabet, size=(rows, W)).astype(np.uint64)
    w = w * np.uint64((1 << 32) // alphabet)
    w[:, 0] //= np.uint64(2)
    return w.astype(np.uint32)


def search_inputs(seed: int, W: int, case: str, cap: int = 64,
                  n_random: int = 40):
    """Inputs of ops/search.py in the JAX package's word form: (table (cap,
    W) uint32, sorted, its rows from table_len on the all-ones SENTINEL;
    table_len; queries (M, W) uint32). `case` sets the live rows: "n0"
    none, "padded" 37/64 of cap, "full" all of cap (unique keys), "dups"
    50/64 of cap drawn from 12 keys of three values a word. The queries
    are every live row, `n_random` random keys, the SENTINEL twice, a key
    above every row and the zero key."""
    rng = np.random.default_rng(seed)
    alphabet = 3 if case == "dups" else 1 << 16
    rows = _key_words(rng, max(300, cap + cap // 2), W, alphabet)
    rows = rows[np.lexsort(rows.T[::-1])]
    if case == "dups":
        n = cap * 50 // 64
        picks = rows[np.linspace(0, len(rows) - 1, 12).astype(np.int64)]
        table_rows = picks[np.sort(rng.integers(0, 12, size=n))]
    else:
        uniq = np.unique(rows, axis=0)
        n = {"n0": 0, "padded": cap * 37 // 64, "full": cap}[case]
        table_rows = uniq[np.sort(rng.choice(len(uniq), n, replace=False))]
    table = np.full((cap, W), 0xFFFFFFFF, np.uint32)
    table[:n] = table_rows
    sentinel = np.full((1, W), 0xFFFFFFFF, np.uint32)
    above = np.full((1, W), 0xFFFFFFFE, np.uint32)
    queries = np.concatenate([table_rows, _key_words(rng, n_random, W,
                                                     alphabet),
                              sentinel, sentinel, above,
                              np.zeros((1, W), np.uint32)])
    return table, n, queries
