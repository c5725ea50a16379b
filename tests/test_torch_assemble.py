"""`assemble` end to end: the port's CLI writes the JAX package's bytes.

Both CLIs run in this process on the same simulated reads — the JAX
package through platanus_b_tpu.commands.main.main, the port through its
own main with PLATANUS_B_TPU_TORCH_DEVICE=cpu (the kernels' plain
versions) — and every output file must be byte-identical.

The `families` cases hold them on a 60 kbp genome with repeat families
planted (torch_families.FAMILIES) at the benchmark's flags (-k 32), and
with a second haplotype at -u 0.1, where bubbles are crushed beside the
repeats (at the default -u 0 no bubble is crushed).
"""

import torch_threads  # noqa: F401  (first: sets torch's CPU threads)

import os

import numpy as np
import pytest

import simdata
import torch_families
from platanus_b_tpu.commands.main import main as jax_main
from platanus_b_tpu_torch.commands.main import main as port_main
from platanus_b_tpu_torch.utils.log import LOG


def _reads(config):
    if config == "families":
        return torch_families.families_reads()
    if config == "families_het":
        return torch_families.families_reads(het=0.005)
    rng = np.random.default_rng(7)
    if config == "bubble":
        g = simdata.random_genome(rng, 2500)
        g2 = simdata.mutate(rng, g, 0.01)
        return (simdata.shotgun_reads(rng, g, 100, 25.0, 0.003)
                + simdata.shotgun_reads(rng, g2, 100, 25.0, 0.003))
    if config == "repeat":
        # a unit at 4x copy number: -repeat keeps repeat-grade coverage only
        unit = simdata.random_genome(rng, 500)
        g = "".join(simdata.random_genome(rng, 250) + unit for _ in range(4))
        return simdata.shotgun_reads(rng, g, 100, 60.0, error_rate=0.002)
    g = simdata.random_genome(rng, 3000)
    return simdata.shotgun_reads(rng, g, 100, 50.0, error_rate=0.005)


CONFIGS = {
    "extend_k": (["-k", "25", "-s", "10"], ["contig.fa", "25merFrq.tsv"]),
    "bubble": (["-k", "25", "-u", "0.1"],
               ["contig.fa", "contigBubble.fa", "25merFrq.tsv"]),
    "repeat": (["-k", "25", "-repeat"], ["contig.fa", "25merFrq.tsv"]),
    "kmer_occ_only": (["-k", "25", "-kmer_occ_only"],
                      ["kmer_occ.bin", "25merFrq.tsv"]),
    "divide_straight": (["-k", "25", "-divide_straight"],
                        ["contig.fa", "25merFrq.tsv"]),
    "families": (["-k", "32"], ["contig.fa", "32merFrq.tsv"]),
    "families_het": (["-k", "32", "-u", "0.1"],
                     ["contig.fa", "contigBubble.fa", "32merFrq.tsv"]),
}


def _run_both(tmp_path, config, monkeypatch):
    flags, outputs = CONFIGS[config]
    reads = tmp_path / "reads.fa"
    simdata.write_fasta(reads, _reads(config))
    monkeypatch.setenv("PLATANUS_B_TPU_TORCH_DEVICE", "cpu")
    assert jax_main(["assemble", "-f", str(reads), "-o",
                     str(tmp_path / "jax")] + flags) == 0
    LOG.reset()
    assert port_main(["assemble", "-f", str(reads), "-o",
                      str(tmp_path / "port")] + flags) == 0
    return outputs


def _counts(spans):
    """{(stage name, count name): the sum over the stage's records}."""
    out = {}
    for s in spans:
        for name, value in s.counters.items():
            key = (s.name.strip(), name)
            out[key] = out.get(key, 0) + value
    return out


@pytest.mark.parametrize("config", list(CONFIGS))
def test_output_files_byte_identical(tmp_path, config, monkeypatch):
    outputs = _run_both(tmp_path, config, monkeypatch)
    written = sorted(p for p in os.listdir(tmp_path) if p.startswith("jax_"))
    assert written == sorted(f"jax_{o}" for o in outputs)
    for name in outputs:
        want = (tmp_path / f"jax_{name}").read_bytes()
        got = (tmp_path / f"port_{name}").read_bytes()
        assert len(want) > 0, name
        assert got == want, name
    if config.startswith("families"):
        # the repeat path: junction records, and bubbles in the graph
        counts = _counts(LOG.spans)
        names = (tmp_path / "jax_contig.fa").read_text().split(">")[1:]
        junctions = sum(n.startswith("junction") for n in names)
        assert junctions >= 10
        assert counts[("writing outputs", "junctions")] == junctions
        assert counts[("writing outputs", "records")] == len(names)
        assert counts[("average coverage", "bubble_unitigs")] > 0
        if config == "families_het":
            assert counts[("bubble pairs", "pairs")] > 0
            assert counts[("bubble align", "aligned")] > 0
            assert counts[("bubble merge", "crushed")] > 0
    LOG.reset()


def test_missing_read_file_is_typed_error(tmp_path, monkeypatch):
    monkeypatch.setenv("PLATANUS_B_TPU_TORCH_DEVICE", "cpu")
    assert port_main(["assemble", "-f", str(tmp_path / "none.fa")]) == 2
    assert port_main(["assemble"]) == 5
