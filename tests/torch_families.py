"""A 60 kbp genome with bacterial repeat families, for the port's tests:
rRNA-operon-like copies at 0.2 % divergence and two IS-like families of
exact copies, half of each reverse-complemented, planted by the
benchmark's generator (portbench.gen.plant_repeats)."""

import numpy as np

import simdata

FAMILIES = [
    {"name": "rrn", "copies": 5, "length": 1_500, "divergence": 0.002,
     "reverse_share": 0.5},
    {"name": "IS-a", "copies": 6, "length": 700, "divergence": 0.0,
     "reverse_share": 0.5},
    {"name": "IS-b", "copies": 4, "length": 800, "divergence": 0.0,
     "reverse_share": 0.5}]


def families_reads(seed=7, genome_bp=60_000, het=0.0):
    """125 bp reads at 40x with 0.3 % substitutions, both strands, of a
    uniform random genome with FAMILIES planted (portbench's generator).
    With `het` > 0 the genome is diploid: half the reads come from a copy
    carrying substitutions at that rate, so bubbles of two haplotypes
    stand beside the repeats."""
    from portbench import gen
    if not het:
        _genome, reads, _plan = gen.simulate_planted(
            genome_bp, 125, 40, 0.003, seed, FAMILIES)
        return [r.tobytes().decode() for r in gen.BASES[reads]]
    genome, _reads, _plan = gen.simulate_planted(genome_bp, 125, 1, 0.0,
                                                 seed, FAMILIES)
    rng = np.random.default_rng(seed)
    a = gen.BASES[genome].tobytes().decode()
    b = simdata.mutate(rng, a, het)
    return (simdata.shotgun_reads(rng, a, 125, 20.0, 0.003)
            + simdata.shotgun_reads(rng, b, 125, 20.0, 0.003))
