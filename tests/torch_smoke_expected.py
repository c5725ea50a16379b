"""Write platanus_b_tpu_torch/smoke_expected.json: the JAX package's outputs
for chip_smoke.py's bubble configuration (phase 4), its iterate round
without solve_dbg (phase 5), its `iterate -i 1` (phase 6) and its phasing
flow (phase 7, the default solve_dbg), computed on the CPU.

    python tests/torch_smoke_expected.py [--part all|bubble|round|iterate|phasing] [--check-port]

The datasets come from platanus_b_tpu_torch.simulate and tests/simdata.py
(numpy only), so the JAX package here and the port on the card read
identical files. With --check-port the port's plain CPU path runs on the
same inputs and must write the same bytes. A part that is not rerun keeps
its record from the existing file.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

DATASET = {"genome_bp": 200_000, "het_rate": 0.005, "read_len": 125,
           "coverage_each": 20, "error": 0.003, "seed": 123}
FLAGS = ["-u", "0.1"]
OUTPUTS = ("contig.fa", "contigBubble.fa", "32merFrq.tsv")
OUT = os.path.join(REPO, "platanus_b_tpu_torch", "smoke_expected.json")


def _sha(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def bubble_record(tmp: str, check_port: bool) -> dict:
    from platanus_b_tpu.commands.main import main as jax_main
    from platanus_b_tpu_torch.simulate import simulate_two_haplotypes

    reads = os.path.join(tmp, "reads.fa")
    simulate_two_haplotypes(reads, **{
        "genome_size": DATASET["genome_bp"], "het_rate": DATASET["het_rate"],
        "read_len": DATASET["read_len"],
        "coverage_each": DATASET["coverage_each"],
        "error": DATASET["error"], "seed": DATASET["seed"]})
    t0 = time.perf_counter()
    rc = jax_main(["assemble", "-f", reads, "-o", f"{tmp}/jax"] + FLAGS)
    wall = time.perf_counter() - t0
    assert rc == 0, f"JAX assemble exited {rc}"
    sha = {name: _sha(f"{tmp}/jax_{name}") for name in OUTPUTS}
    if check_port:
        from platanus_b_tpu_torch.commands.main import main as port_main
        assert port_main(["assemble", "-f", reads, "-o", f"{tmp}/port"]
                         + FLAGS) == 0
        port = {name: _sha(f"{tmp}/port_{name}") for name in OUTPUTS}
        print("bubble: port on CPU matches:", port == sha)
        assert port == sha, "bubble: the port's CPU bytes differ"
    return {"dataset": DATASET, "flags": FLAGS, "sha256": sha,
            "made_by": "JAX package on the CPU (platanus_b_tpu assemble)",
            "jax_cpu_wall_s": round(wall, 1)}


def round_record(tmp: str, check_port: bool) -> dict:
    import chip_smoke
    from platanus_b_tpu.commands.main import main as jax_main

    ds = chip_smoke.ROUND_DATASET
    data = os.path.join(tmp, "data")
    inputs = chip_smoke.make_round_dataset(data, ds)
    walls = chip_smoke.run_round(os.path.join(tmp, "jax"), data, jax_main)
    sha = chip_smoke.round_hashes(os.path.join(tmp, "jax"))
    if check_port:
        from platanus_b_tpu_torch.commands.main import main as port_main
        chip_smoke.run_round(os.path.join(tmp, "port"), data, port_main)
        port = chip_smoke.round_hashes(os.path.join(tmp, "port"))
        print("round: port on CPU matches:", port == sha)
        assert port == sha, "round: the port's CPU bytes differ"
    return {"dataset": ds, "inputs_sha256": inputs,
            "steps": chip_smoke.ROUND_STEPS, "sha256": sha,
            "made_by": "JAX package on the CPU (platanus_b_tpu, the round's "
                       "commands from the work directory)",
            "jax_cpu_wall_s": {k: round(v, 1) for k, v in walls.items()}}


def iterate_record(tmp: str, check_port: bool) -> dict:
    import chip_smoke
    from platanus_b_tpu.commands.main import main as jax_main

    ds = chip_smoke.ROUND_DATASET
    data = os.path.join(tmp, "data")
    chip_smoke.make_round_dataset(data, ds)
    contigs = chip_smoke.make_iterate_contigs(data, ds)
    wall = chip_smoke.run_iterate(os.path.join(tmp, "jax_it"), data, jax_main)
    sha = chip_smoke.iterate_hashes(os.path.join(tmp, "jax_it"))
    inter = os.path.join(tmp, "jax_it", "it_iterateIntermediateResults", "it1")
    n_div = chip_smoke.fasta_count(os.path.join(inter, "it_kmerDivided.fa"))
    n_cons = chip_smoke.fasta_count(os.path.join(inter,
                                                 "it_consensusScaffold.fa"))
    print(f"iterate: {n_div} kmerDivided records, {n_cons} consensus "
          f"scaffolds")
    if check_port:
        from platanus_b_tpu_torch.commands.main import main as port_main
        chip_smoke.run_iterate(os.path.join(tmp, "port_it"), data, port_main)
        port = chip_smoke.iterate_hashes(os.path.join(tmp, "port_it"))
        print("iterate: port on CPU matches:", port == sha)
        assert port == sha, "iterate: the port's CPU bytes differ"
    return {"dataset": ds, "contigs_sha256": contigs,
            "argv": chip_smoke.ITERATE_ARGV, "sha256": sha,
            "num_kmer_divided": n_div, "num_consensus_scaffolds": n_cons,
            "made_by": "JAX package on the CPU (platanus_b_tpu iterate from "
                       "the work directory)",
            "jax_cpu_wall_s": round(wall, 1)}


def phasing_record(tmp: str, check_port: bool) -> dict:
    import chip_smoke
    from platanus_b_tpu.commands.main import main as jax_main

    ds = chip_smoke.PHASING_DATASET
    jax_dir = os.path.join(tmp, "jax_phase")
    contigs = chip_smoke.make_phasing_contigs(jax_dir, ds)
    wall = chip_smoke.run_phasing(jax_dir, jax_main)
    sha = chip_smoke.phasing_hashes(jax_dir)
    if check_port:
        from platanus_b_tpu_torch.commands.main import main as port_main
        port_dir = os.path.join(tmp, "port_phase")
        chip_smoke.make_phasing_contigs(port_dir, ds)
        chip_smoke.run_phasing(port_dir, port_main)
        port = chip_smoke.phasing_hashes(port_dir)
        print("phasing: port on CPU matches:", port == sha)
        assert port == sha, "phasing: the port's CPU bytes differ"
    return {"dataset": ds, "contigs_sha256": contigs,
            "argv": chip_smoke.PHASING_ARGV, "sha256": sha,
            "made_by": "JAX package on the CPU (platanus_b_tpu solve_dbg "
                       "from the work directory; segment verification on "
                       "the host at band 64)",
            "jax_cpu_wall_s": round(wall, 1)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--part", choices=("all", "bubble", "round", "iterate",
                                       "phasing"), default="all")
    ap.add_argument("--check-port", action="store_true")
    args = ap.parse_args()
    os.environ["PLATANUS_B_TPU_PLATFORM"] = "cpu"
    os.environ["PLATANUS_B_TPU_TORCH_DEVICE"] = "cpu"
    record = {}
    if os.path.exists(OUT):
        with open(OUT) as f:
            record = json.load(f)
    with tempfile.TemporaryDirectory() as tmp:
        if args.part in ("all", "bubble"):
            record.update(bubble_record(tmp, args.check_port))
        if args.part in ("all", "round"):
            record["round"] = round_record(tmp, args.check_port)
        if args.part in ("all", "iterate"):
            record["iterate"] = iterate_record(tmp, args.check_port)
        if args.part in ("all", "phasing"):
            record["phasing"] = phasing_record(tmp, args.check_port)
    record["command"] = "python tests/torch_smoke_expected.py"
    with open(OUT, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
