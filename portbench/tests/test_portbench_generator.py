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
