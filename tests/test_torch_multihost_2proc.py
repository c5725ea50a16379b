"""The port's multi-process layer at world 2, against the JAX package.

One module-scoped fixture starts two gloo ranks on the CPU
(tests/torch_mh_worker.py, which imports no jax; PLATANUS_B_TPU_TORCH_DEVICE
=cpu, MASTER_ADDR=127.0.0.1, a free port) and, beside them, a 2-rank
`torchrun ... -m platanus_b_tpu_torch assemble`. Every comparison with the
JAX package is exact: the global table, each rank's key-range shard, the
histograms, the contig set, the device layer's shards, adjacency and
mapping (against the JAX functions on a 2-device mesh, shard for shard),
and the CLI's files.
"""

import torch_threads  # noqa: F401  (first: sets torch's CPU threads)

import json
import os
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest

import simdata
from platanus_b_tpu.commands.main import main as jax_main
from platanus_b_tpu.io.fasta import seq_to_codes
from platanus_b_tpu.io.reads import load_read_batches, pack_reads
from platanus_b_tpu.models.assemble_core import (AssembleOptions, assemble,
                                                 count_reads)
from platanus_b_tpu.parallel import multihost as jmh
from platanus_b_tpu.parallel import sharding as jsh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
TIMEOUT_S = 240  # each process's own limit; all are killed on a failure


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, PLATANUS_B_TPU_TORCH_DEVICE="cpu",
               OMP_NUM_THREADS="2", **extra)
    return env


def _wait_all(procs: dict) -> dict:
    """Wait for every process within TIMEOUT_S; the first one that fails
    or outlives the limit kills the rest. Returns each one's output."""
    deadline = time.monotonic() + TIMEOUT_S
    logs = {}
    try:
        while len(logs) < len(procs):
            for name, p in procs.items():
                if name in logs or p.poll() is None:
                    continue
                logs[name] = p.stdout.read()
                if p.returncode != 0:
                    pytest.fail(f"{name} exited {p.returncode}:\n"
                                f"{logs[name][-4000:]}")
            if time.monotonic() > deadline:
                pytest.fail(f"timed out after {TIMEOUT_S} s: "
                            f"{sorted(set(procs) - set(logs))}")
            time.sleep(0.1)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait()
    return logs


@pytest.fixture(scope="module")
def run2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_mh2")
    rng = np.random.default_rng(11)
    genome = simdata.random_genome(rng, 3000)
    reads = simdata.shotgun_reads(rng, genome, 100, 30.0, error_rate=0.005)
    fasta = tmp / "reads.fa"
    simdata.write_fasta(fasta, reads)
    g2 = simdata.random_genome(rng, 3000)
    map_reads = simdata.shotgun_reads(rng, g2, 80, 8.0)
    map_reads = map_reads[: len(map_reads) // WORLD * WORLD]
    map_batch = pack_reads(map_reads)
    np.savez(tmp / "inputs.npz", contig0=seq_to_codes(g2[:1500]),
             contig1=seq_to_codes(g2[1500:]), map_codes=map_batch.codes,
             map_lengths=map_batch.lengths)

    port = _free_port()
    procs = {}
    for r in range(WORLD):
        procs[f"rank {r}"] = subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests", "torch_mh_worker.py"),
             str(tmp), str(tmp / "inputs.npz"), str(fasta)],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
            env=_env(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                     WORLD_SIZE=str(WORLD), RANK=str(r), LOCAL_RANK=str(r)))
    cli = tmp / "cli"
    cli.mkdir()
    procs["torchrun assemble"] = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(WORLD), "-m", "platanus_b_tpu_torch",
         "assemble", "-k", "15", "-f", str(fasta), "-o", "mp"],
        cwd=cli, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env())
    logs = _wait_all(procs)
    results = []
    for r in range(WORLD):
        res = json.loads((tmp / f"rank{r}.json").read_text())
        assert res["ok"], res.get("error")
        results.append((res, dict(np.load(tmp / f"rank{r}.npz"))))
    batch = list(load_read_batches([str(fasta)]))
    return {"results": results, "batches": batch, "fasta": fasta,
            "map": map_batch, "map_contigs": [g2[:1500], g2[1500:]],
            "cli": cli, "logs": logs}


def _mesh():
    return jsh.make_mesh(jax.devices()[:WORLD])


def _canonical(contigs) -> np.ndarray:
    canon = sorted(min(bytes(c), bytes((3 - c)[::-1])) for c in contigs)
    return np.frombuffer(b"\xff".join(canon), np.uint8)


def _jax_shards(batches, k):
    """The JAX package's sharded_count_fn on a 2-device mesh: each shard's
    (keys, counts), the histogram, and `dropped`."""
    codes = np.concatenate([b.codes for b in batches])
    pad = (-len(codes)) % WORLD
    codes = np.concatenate([codes, np.full((pad, codes.shape[1]), 4,
                                           np.uint8)])
    fn, _cap = jsh.sharded_count_fn(_mesh(), k, len(codes) // WORLD,
                                    codes.shape[1])
    out = fn(jax.numpy.asarray(codes))
    keys, counts, n_unique, hist, dropped = (np.asarray(x) for x in out)
    return keys, counts, n_unique, hist, int(dropped), out


def test_ingest_partitions_reads(run2):
    results = run2["results"]
    assert [res["world"] for res, _ in results] == [WORLD, WORLD]
    # the one file is split by byte range, no read is read twice
    assert all(res["local_reads"] > 0 for res, _ in results)
    assert sum(res["local_reads"] for res, _ in results) == sum(
        b.num_reads for b in run2["batches"])
    assert all(res["plan"][0][1:] != [0, -1] for res, _ in results)


@pytest.mark.parametrize("k", [15, 48])
def test_global_count_equals_count_reads(run2, k):
    table, hist = count_reads(run2["batches"], k)
    for _res, a in run2["results"]:
        np.testing.assert_array_equal(a[f"count{k}_keys"], table.keys)
        np.testing.assert_array_equal(a[f"count{k}_counts"], table.counts)
        np.testing.assert_array_equal(a[f"count{k}_hist"], hist)


def test_empty_rank_count_equals_count_reads(run2):
    table, hist = count_reads(run2["batches"], 15)
    for _res, a in run2["results"]:
        np.testing.assert_array_equal(a["empty_rank_keys"], table.keys)
        np.testing.assert_array_equal(a["empty_rank_counts"], table.counts)
        np.testing.assert_array_equal(a["empty_rank_hist"], hist)


def test_sharded_merge_keeps_each_ranks_key_range(run2):
    table, _hist = count_reads(run2["batches"], 15)
    dest = jmh.shard_range_of(table.keys, WORLD, 15)
    for r, (_res, a) in enumerate(run2["results"]):
        np.testing.assert_array_equal(a["shard_keys"], table.keys[dest == r])
        np.testing.assert_array_equal(a["shard_counts"],
                                      table.counts[dest == r])
        assert 0 < len(a["shard_keys"]) < len(table.keys)


def test_host_collectives(run2):
    (res0, a0), (res1, a1) = run2["results"]
    for a in (a0, a1):
        assert a["psum"].tolist() == [3, 6, 9]
        assert a["bcast"].tolist() == [0, 1, 2]
        assert a["concat"].tolist() == [[0, 0], [1, 1], [1, 1]]
        assert a["merge_keys"].tolist() == [[0, 0], [1, 0], [2, 0]]
        assert a["merge_counts"].tolist() == [5, 5, 15]
    assert a0["host0_gather"].tolist() == [[0, 0], [1, 1], [1, 1]]
    assert not res0["host0_gather_is_none"] and res1["host0_gather_is_none"]


def test_assemble_world2_equals_single_process(run2):
    res = assemble(run2["batches"], AssembleOptions(k=15))
    want = _canonical(res.contigs)
    for res_r, a in run2["results"]:
        assert res_r["n_contigs"] == len(res.contigs) > 0
        np.testing.assert_array_equal(a["contigs"], want)


def test_kmer_occ_only_world2_equals_single_process(run2):
    res = assemble(run2["batches"], AssembleOptions(k=15, kmer_occ_only=True))
    for _r, a in run2["results"]:
        np.testing.assert_array_equal(a["occ_keys"], res.kmer_table.keys)
        np.testing.assert_array_equal(a["occ_counts"], res.kmer_table.counts)
        np.testing.assert_array_equal(a["occ_hist"], res.hist0)


@pytest.mark.parametrize("k", [15, 32, 48])
def test_sharded_count_equals_jax_shard_for_shard(run2, k):
    keys, counts, n_unique, hist, dropped, _ = _jax_shards(run2["batches"], k)
    assert dropped == 0
    for r, (_res, a) in enumerate(run2["results"]):
        np.testing.assert_array_equal(a[f"sc{k}_keys"], keys[r, : n_unique[r]])
        np.testing.assert_array_equal(a[f"sc{k}_counts"],
                                      counts[r, : n_unique[r]])
        np.testing.assert_array_equal(a[f"sc{k}_hist"], hist)


def test_count_reads_sharded_equals_jax(run2):
    codes = np.concatenate([b.codes for b in run2["batches"]])
    keys, counts, hist, dropped = jsh.count_reads_sharded(_mesh(), codes, 32)
    assert dropped == 0
    for _res, a in run2["results"]:
        np.testing.assert_array_equal(a["crs_keys"], keys)
        np.testing.assert_array_equal(a["crs_counts"], counts)
        np.testing.assert_array_equal(a["crs_hist"], hist)


def test_sharded_adjacency_equals_jax_shard_for_shard(run2):
    keys, _c, n_unique, _h, dropped, dev_out = _jax_shards(run2["batches"],
                                                           21)
    assert dropped == 0
    adj = jsh.sharded_adjacency_fn(_mesh(), 21, keys.shape[1])
    out, junc, n_junc, n_edge = (np.asarray(x) for x in
                                 adj(dev_out[0], dev_out[1], dev_out[2]))
    assert int(junc.sum()) > 0
    for r, (res, a) in enumerate(run2["results"]):
        np.testing.assert_array_equal(a["sc21_keys"], keys[r, : n_unique[r]])
        np.testing.assert_array_equal(a["adj_out"], out[r, : n_unique[r]])
        np.testing.assert_array_equal(a["adj_junction"],
                                      junc[r, : n_unique[r]])
        assert res["adj_n_junction"] == int(n_junc)
        assert res["adj_n_edge"] == int(n_edge)


def test_sharded_map_equals_jax_shard_for_shard(run2):
    from platanus_b_tpu.models.mapper import ContigIndex
    batch = run2["map"]
    index = ContigIndex([seq_to_codes(s) for s in run2["map_contigs"]],
                        key_length=32)
    R, L = batch.codes.shape
    fn = jsh.sharded_map_fn(_mesh(), index, 32, 32, R // WORLD, L)
    ids, offs, hist = (np.asarray(x) for x in
                       fn(jax.numpy.asarray(batch.codes),
                          jax.numpy.asarray(batch.lengths)))
    half = R // WORLD
    assert (ids != 0).sum() > R // 2
    for r, (_res, a) in enumerate(run2["results"]):
        np.testing.assert_array_equal(a["map_ids"], ids[r * half:
                                                        (r + 1) * half])
        np.testing.assert_array_equal(a["map_offs"], offs[r * half:
                                                          (r + 1) * half])
        np.testing.assert_array_equal(a["map_hist"], hist)


def test_cli_assemble_world2_writes_the_jax_bytes(run2, tmp_path):
    """torchrun's two ranks of `assemble`: the one read file is below
    host_read_plan's 64 MiB, so rank 0 reads it whole and rank 1 counts
    nothing, yet enters every collective; rank 0 alone writes, and its
    files are the JAX package's bytes."""
    assert jax_main(["assemble", "-k", "15", "-f", str(run2["fasta"]),
                     "-o", str(tmp_path / "jax")]) == 0
    cli = run2["cli"]
    written = sorted(os.listdir(cli))
    assert written == ["mp_15merFrq.tsv", "mp_contig.fa"], written
    for name in written:
        want = (tmp_path / name.replace("mp_", "jax_")).read_bytes()
        assert len(want) > 0
        assert (cli / name).read_bytes() == want, name
    log = run2["logs"]["torchrun assemble"]
    assert "multi-host runtime: process 1 of 2" in log
    assert "assemble completed (non-zero host, no output)!" in log
