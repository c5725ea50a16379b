"""The frozen generator against the port's simulate.simulate_reads."""

import numpy as np
import pytest

from platanus_b_tpu_torch.simulate import simulate_reads
from portbench import gen


@pytest.mark.parametrize("genome_bp,coverage,seed", [
    (20_000, 40, 123), (31_337, 100, 7), (5_000, 40, 2**31 + 5)])
def test_same_draws_and_file(tmp_path, genome_bp, coverage, seed):
    want = simulate_reads(str(tmp_path / "want.fa"), genome_bp, 125,
                          coverage, 0.003, seed)
    genome, reads = gen.simulate(genome_bp, 125, coverage, 0.003, seed)
    gen.write_fasta(str(tmp_path / "got.fa"), reads)
    assert gen.BASES[genome].tobytes().decode() == want
    assert (tmp_path / "got.fa").read_bytes() == (tmp_path / "want.fa").read_bytes()
    assert reads.shape == (genome_bp * coverage // 125, 125)


def test_any_whole_seed():
    a = gen.simulate(2_000, 125, 40, 0.003, -3)[1]
    b = gen.simulate(2_000, 125, 40, 0.003, -3)[1]
    assert np.array_equal(a, b)
    assert gen.rng_of(2**40).integers(0, 4) in range(4)


def test_window_data_fixed_checked_data_from_the_seed(tmp_path):
    from portbench import harness
    config = {"genome_bp": 3_000, "dataset_seed": 123}
    mix = {"read_len": 125, "coverage": 40, "error": 0.003}
    a = harness.make_inputs(config, mix, 5, str(tmp_path))
    b = harness.make_inputs(config, mix, 6, str(tmp_path))
    assert np.array_equal(a.genome, b.genome) and np.array_equal(a.reads, b.reads)
    c = harness.seed_inputs(config, mix, 5, str(tmp_path))
    d = harness.seed_inputs(config, mix, 6, str(tmp_path))
    assert not np.array_equal(c.genome, d.genome)
    assert c.reads.shape == d.reads.shape == a.reads.shape


# sha256 of the genome codes and of the read matrix at seed 123, as the
# generator drew them before it could plant repeats
PARENT_DATA = {
    ("isolate-1000k", "reads125-40x"): (
        "7d6544d29d7d80e79a0f771e3e7083affd9805d8414ed7903d78b4d8d9425b3f",
        "079939016d718c3a449f31c906496d8f421dd2993d0ea1cd137fbe10cb67c637"),
    ("isolate-4600k", "reads125-40x"): (
        "767fe432d6c00f1d3a7518e3c5ae3969b3ed248abc4b4e75f216c594dbf3edef",
        "ec9b8e5c23ae516834b77651dee2238b4d473446aa68525be6018e0fd11b5142"),
}


@pytest.mark.parametrize("config,mix", sorted(PARENT_DATA))
def test_repeat_free_configurations_keep_their_data(config, mix):
    import hashlib

    from portbench import harness
    cfg = harness.load_json(harness.config_file(config))
    assert "repeats" not in cfg and cfg["dataset_seed"] == 123
    genome, reads, plan = harness.dataset(
        cfg, harness.load_json(harness.mix_file(mix)), cfg["dataset_seed"])
    assert not plan.copies
    assert (hashlib.sha256(genome.tobytes()).hexdigest(),
            hashlib.sha256(reads.tobytes()).hexdigest()) == PARENT_DATA[config, mix]


FAMILIES = [
    {"name": "rrn", "copies": 5, "length": 2_000, "divergence": 0.002,
     "reverse_share": 0.5},
    {"name": "IS", "copies": 7, "length": 600, "divergence": 0.01,
     "reverse_share": 0.3},
    {"name": "exact", "copies": 3, "length": 900, "divergence": 0.0,
     "reverse_share": 0.5}]


@pytest.mark.parametrize("seed", [3, 2**31 + 7])
def test_planted_copies(seed):
    G, L = 60_000, 125
    genome, reads, plan = gen.simulate_planted(G, L, 40, 0.003, seed, FAMILIES)
    bare, bare_reads = gen.simulate(G, L, 40, 0.003, seed)
    assert genome.shape == (G,)
    planted = dict(zip(plan.copies, plan.sequences(genome)))
    for fam in FAMILIES:
        copies = [c for c in plan.copies if c.family == fam["name"]]
        assert len(copies) == fam["copies"]
        assert sum(c.reverse for c in copies) == int(
            fam["reverse_share"] * fam["copies"] + 0.5)
        tmpl = plan.templates[fam["name"]]
        for c in copies:
            seq = planted[c]
            assert np.array_equal(seq, genome[c.start: c.start + c.length])
            fwd = 3 - seq[::-1] if c.reverse else seq
            assert c.length == fam["length"]
            assert int((fwd != tmpl).sum()) == int(
                fam["divergence"] * fam["length"] + 0.5)
    # disjoint slots, a read length apart, none past the end; the rest of
    # the genome is the repeat-free draw
    slots = sorted((c.start, c.start + c.length) for c in plan.copies)
    assert slots[0][0] >= 0 and slots[-1][1] <= G
    assert all(b[0] - a[1] >= L for a, b in zip(slots, slots[1:]))
    inside = np.zeros(G, bool)
    for a, b in slots:
        inside[a:b] = True
    assert np.array_equal(genome[~inside], bare[~inside])
    # the reads start where the repeat-free draw's start: a read that
    # overlaps no copy is the same bytes, one that does holds the planted
    # bases up to its errors
    rng = gen.rng_of(seed)
    rng.integers(0, 4, size=G, dtype=np.uint8)
    starts = rng.integers(0, G - L, size=len(reads))
    hit = np.array([inside[s: s + L].any() for s in starts])
    assert 0 < hit.sum() < len(reads)
    assert np.array_equal(reads[~hit], bare_reads[~hit])
    win = np.lib.stride_tricks.sliding_window_view(genome, L)[starts[hit]]
    off = np.minimum((reads[hit] != win).sum(1),
                     (reads[hit] != 3 - win[:, ::-1]).sum(1))
    assert off.max() <= 6


def test_planted_repeats_do_not_fit():
    with pytest.raises(ValueError):
        gen.simulate_planted(5_000, 125, 40, 0.003, 1, FAMILIES)
