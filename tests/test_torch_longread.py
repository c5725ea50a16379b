"""The port's minimizer sketch and long-read aligner (ops/minimizer.py,
models/longread.py) against the JAX package's on the same inputs: the
sketch whole, and every alignment's PAF line."""

import torch_threads  # noqa: F401  (first: sets torch's CPU threads)

import numpy as np
import pytest

import simdata
from platanus_b_tpu.io.fasta import seq_to_codes
from platanus_b_tpu.models import longread as jlongread
from platanus_b_tpu.ops import minimizer as jminimizer
from platanus_b_tpu_torch.models import longread as tlongread
from platanus_b_tpu_torch.ops import minimizer as tminimizer


@pytest.fixture(scope="module")
def seqs():
    """tests/test_phase.py:50's haplotigs beside a 25 kbp contig, a 2%
    divergent copy of part of it, and a read with an N run."""
    rng = np.random.default_rng(42)
    homo = simdata.random_genome(rng, 25000)
    hap1 = simdata.random_genome(rng, 12000)
    hap2 = simdata.mutate(rng, hap1, 0.003)
    part = simdata.mutate(rng, homo[3000:9000], 0.02)
    with_n = hap1[:4000] + "N" * 50 + simdata.rc(hap1[4000:7000])
    return [seq_to_codes(s) for s in (homo, hap1, hap2, part, with_n)]


@pytest.mark.parametrize("k,w", [(19, 19), (15, 10), (15, 5), (21, 40)])
def test_sketch_equal(seqs, k, w):
    mat, lens = jlongread._pad_batch(seqs)
    want = jminimizer.sketch(mat, lens, k, w)
    got = tminimizer.sketch(mat, lens, k, w)
    assert len(got) == len(want)
    for (h1, p1, s1), (h2, p2, s2) in zip(want, got):
        assert h2.dtype == h1.dtype and np.array_equal(h2, h1)
        assert p2.dtype == p1.dtype and np.array_equal(p2, p1)
        assert s2.dtype == s1.dtype and np.array_equal(s2, s1)


@pytest.mark.parametrize("preset", ["asm10", "map-ont"])
def test_align_batch_equal(seqs, monkeypatch, preset):
    monkeypatch.setenv("PLATANUS_B_TPU_TORCH_DEVICE", "cpu")
    names = [str(i) for i in range(len(seqs))]
    want = jlongread.LongReadAligner(seqs[:3], names[:3],
                                     preset).align_batch(seqs, names)
    got = tlongread.LongReadAligner(seqs[:3], names[:3],
                                    preset).align_batch(seqs, names)
    assert [a.paf_line() for a in got] == [a.paf_line() for a in want]
    # the haplotigs align onto each other, and the divergent copy onto
    # the 25 kbp contig
    pairs = {(a.q_name, a.t_name) for a in want}
    assert ("2", "1") in pairs and ("3", "0") in pairs
