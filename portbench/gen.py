"""The reads of a job, made from a seed (numpy only).

A frozen copy of the port's `simulate.simulate_reads` (the generator of
`parity/run_parity.py`): a uniform random genome, fixed-length reads from
both strands, uniform substitution errors, with the same random draws in
the same order, so that seed 123 at 1 and 4.6 Mbp, 125 bp, 40x and 0.3 %
gives the parity records' read sets. Only the writing is faster.

`plant_repeats` overwrites slots of the drawn genome with copies of
repeat families (a configuration's `repeats`). It draws from a generator
of its own, derived from the same seed, between the genome's draw and the
reads', so every read start, strand flip and error draw is the same as
on the repeat-free genome.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def rng_of(seed: int) -> np.random.Generator:
    """numpy's generator for any whole seed (negative ones wrap to 64 bits)."""
    return np.random.default_rng(int(seed) % (1 << 64))


@dataclass(frozen=True)
class Copy:
    """One planted copy: its family, its slot genome[start:start + length]
    and whether it is the family's template reverse-complemented."""
    family: str
    start: int
    length: int
    reverse: bool


@dataclass(frozen=True)
class Plan:
    """The planted copies, in the order they were drawn, and each family's
    template (uint8 codes 0-3)."""
    copies: tuple[Copy, ...] = ()
    templates: dict = field(default_factory=dict)

    def sequences(self, genome: np.ndarray) -> list[np.ndarray]:
        """Each copy's codes as planted in `genome`."""
        return [genome[c.start: c.start + c.length] for c in self.copies]


def _substituted(rng: np.random.Generator, codes: np.ndarray,
                 n: int) -> np.ndarray:
    """`codes` with n distinct positions changed to another base."""
    out = codes.copy()
    at = rng.choice(len(out), size=n, replace=False)
    out[at] = (out[at] + rng.integers(1, 4, size=n)) % 4
    return out


def plant_repeats(genome: np.ndarray, repeats, seed: int,
                  gap: int) -> tuple[np.ndarray, Plan]:
    """(genome with the copies written over it, the plan). Each family of
    `repeats` ({name, copies, length, divergence, reverse_share}) gets a
    uniform random template; each copy carries divergence * length
    substitutions at distinct positions, and reverse_share * copies of a
    family's copies are reverse-complemented (both rounded half up). The
    copies lie in a random order on disjoint slots, at least `gap` bases
    apart, none past the genome's end. Without families the genome is
    returned as it is."""
    if not repeats:
        return genome, Plan()
    rng = np.random.default_rng([int(seed) % (1 << 64), 1])
    templates, seqs, meta = {}, [], []
    for fam in repeats:
        name, n, length = fam["name"], int(fam["copies"]), int(fam["length"])
        if name in templates or n < 1 or length < 1:
            raise ValueError(f"repeat family {name!r}: a new name, at "
                             "least one copy of at least one base")
        templates[name] = tmpl = rng.integers(0, 4, size=length,
                                              dtype=np.uint8)
        n_sub = int(float(fam["divergence"]) * length + 0.5)
        n_rev = int(float(fam["reverse_share"]) * n + 0.5)
        reverse = np.zeros(n, bool)
        reverse[rng.permutation(n)[:n_rev]] = True
        for rev in reverse:
            seq = _substituted(rng, tmpl, n_sub)
            seqs.append(3 - seq[::-1] if rev else seq)
            meta.append((name, bool(rev)))
    lens = np.array([len(x) for x in seqs], np.int64)
    slack = len(genome) - int(lens.sum()) - gap * (len(seqs) - 1)
    if slack < 0:
        raise ValueError(f"{len(seqs)} copies of {int(lens.sum())} bases "
                         f"do not fit {len(genome)} bases {gap} apart")
    order = rng.permutation(len(seqs))
    shift = np.sort(rng.integers(0, slack + 1, size=len(seqs)))
    before = np.concatenate([[0], np.cumsum(lens[order] + gap)[:-1]])
    starts = np.empty(len(seqs), np.int64)
    starts[order] = shift + before
    out = genome.copy()
    copies = []
    for (name, rev), seq, start in zip(meta, seqs, starts):
        out[start: start + len(seq)] = seq
        copies.append(Copy(name, int(start), len(seq), rev))
    return out, Plan(tuple(copies), templates)


def simulate_planted(genome_bp: int, read_len: int, coverage: float,
                     error: float, seed: int, repeats=()
                     ) -> tuple[np.ndarray, np.ndarray, Plan]:
    """(genome codes (G,) uint8, reads (R, read_len) uint8 codes 0-3, the
    plan): `simulate`'s draws, with `repeats` planted (copies at least
    one read length apart) after the genome's draw and before the reads'."""
    rng = rng_of(seed)
    genome = rng.integers(0, 4, size=genome_bp, dtype=np.uint8)
    genome, plan = plant_repeats(genome, repeats, seed, read_len)
    n_reads = genome_bp * int(coverage) // read_len
    starts = rng.integers(0, genome_bp - read_len, size=n_reads)
    reads = np.lib.stride_tricks.sliding_window_view(genome, read_len)[starts]
    flip = rng.random(n_reads) < 0.5
    reads[flip] = 3 - reads[flip, ::-1]
    mask = rng.random(reads.shape) < error
    reads[mask] = (reads[mask] + rng.integers(1, 4, size=int(mask.sum()))) % 4
    return genome, reads, plan


def simulate(genome_bp: int, read_len: int, coverage: float, error: float,
             seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(genome codes (G,) uint8, reads (R, read_len) uint8 codes 0-3)."""
    return simulate_planted(genome_bp, read_len, coverage, error, seed)[:2]


def write_fasta(path: str, reads: np.ndarray) -> None:
    """reads as FASTA records `>r<i>` with the read on one line, built as
    one byte block for each run of names with as many digits."""
    n, ln = reads.shape
    with open(path, "wb") as f:
        lo, digits = 0, 1
        while lo < n:
            hi = min(n, 10 ** digits)
            idx = np.arange(lo, hi)
            block = np.empty((hi - lo, digits + ln + 4), np.uint8)
            block[:, 0], block[:, 1] = ord(">"), ord("r")
            for d in range(digits):
                block[:, 2 + d] = ord("0") + (idx // 10 ** (digits - 1 - d)) % 10
            block[:, 2 + digits] = ord("\n")
            block[:, 3 + digits: 3 + digits + ln] = BASES[reads[lo:hi]]
            block[:, -1] = ord("\n")
            f.write(block.tobytes())
            lo, digits = hi, digits + 1
