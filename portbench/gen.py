"""The reads of a job, made from a seed (numpy only).

A frozen copy of the port's `simulate.simulate_reads` (the generator of
`parity/run_parity.py`): a uniform random genome, fixed-length reads from
both strands, uniform substitution errors, with the same random draws in
the same order, so that seed 123 at 1 and 4.6 Mbp, 125 bp, 40x and 0.3 %
gives the parity records' read sets. Only the writing is faster.
"""

from __future__ import annotations

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def rng_of(seed: int) -> np.random.Generator:
    """numpy's generator for any whole seed (negative ones wrap to 64 bits)."""
    return np.random.default_rng(int(seed) % (1 << 64))


def simulate(genome_bp: int, read_len: int, coverage: float, error: float,
             seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(genome codes (G,) uint8, reads (R, read_len) uint8 codes 0-3)."""
    rng = rng_of(seed)
    genome = rng.integers(0, 4, size=genome_bp, dtype=np.uint8)
    n_reads = genome_bp * int(coverage) // read_len
    starts = rng.integers(0, genome_bp - read_len, size=n_reads)
    reads = np.lib.stride_tricks.sliding_window_view(genome, read_len)[starts]
    flip = rng.random(n_reads) < 0.5
    reads[flip] = 3 - reads[flip, ::-1]
    mask = rng.random(reads.shape) < error
    reads[mask] = (reads[mask] + rng.integers(1, 4, size=int(mask.sum()))) % 4
    return genome, reads


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
