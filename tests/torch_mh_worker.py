"""One rank of tests/test_torch_multihost_2proc.py; imports no jax.

    python tests/torch_mh_worker.py OUT_DIR INPUTS.npz READS.fa

with torchrun's variables (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK,
LOCAL_RANK) and PLATANUS_B_TPU_TORCH_DEVICE=cpu set. It drives the port's
multi-process paths over gloo: byte-range ingest, the global count, the
key-range sharded merge, the host collectives, `assemble` (and its
-kmer_occ_only branch), and the device layer (sharded_count,
count_reads_sharded, sharded_adjacency, sharded_map). It writes
OUT_DIR/rank<r>.npz (arrays) and OUT_DIR/rank<r>.json (scalars, "ok", and
the traceback of a failure) for the parent to compare with the JAX
package.
"""

import json
import os
import sys
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402


def canonical_contigs(contigs) -> np.ndarray:
    """The sorted canonical contig set as one uint8 row, 255 between
    contigs (the parent builds the same row from the JAX package's)."""
    canon = sorted(min(bytes(c), bytes((3 - c)[::-1])) for c in contigs)
    return np.frombuffer(b"\xff".join(canon), np.uint8)


def run(inputs_path: str, fasta: str, res: dict, arrays: dict) -> None:
    from platanus_b_tpu_torch.io.reads import load_read_batches
    from platanus_b_tpu_torch.models.assemble_core import (
        AssembleOptions, assemble, count_reads, count_reads_device,
        stage_reads)
    from platanus_b_tpu_torch.models.mapper import ContigIndex
    from platanus_b_tpu_torch.ops.keys import keys_to_words
    from platanus_b_tpu_torch.parallel import multihost as mh
    from platanus_b_tpu_torch.parallel import sharding

    assert mh.initialize(), "the process group did not initialize"
    r, n = mh.process_index(), mh.process_count()
    res.update(rank=r, world=n)
    dev = torch.device("cpu")

    # ingest: a byte-range slice of the one read file
    plan = mh.host_read_plan([fasta], min_chunk=1 << 10)
    res["plan"] = [[p, int(a), int(b)] for p, a, b in plan]
    batches = list(load_read_batches(plan))
    res["local_reads"] = sum(b.num_reads for b in batches)
    reads = stage_reads(batches, dev)

    # the global table of every rank's reads, replicated
    for k in (15, 48):
        table, hist = count_reads(reads, k)
        arrays[f"count{k}_keys"], arrays[f"count{k}_counts"] = \
            table.host_words()
        arrays[f"count{k}_hist"] = hist
    # a rank with no reads still enters every collective
    whole = list(load_read_batches([fasta])) if r == 0 else []
    table, hist = count_reads(stage_reads(whole, dev), 15)
    arrays["empty_rank_keys"], arrays["empty_rank_counts"] = \
        table.host_words()
    arrays["empty_rank_hist"] = hist

    # key-range sharded merge of the ranks' local tables
    keys, counts, _n, _h = count_reads_device(reads, 15)
    arrays["shard_keys"], arrays["shard_counts"] = \
        mh.global_count_merge_sharded(
            keys_to_words(keys, 15), counts.numpy().astype(np.uint32), k=15)

    # host collectives
    arrays["psum"] = mh.psum_histogram(np.asarray([1, 2, 3], np.int64)
                                       * (r + 1))
    arrays["bcast"] = mh.broadcast_from_host0(np.arange(3, dtype=np.int32)
                                              + 10 * r)
    arrays["concat"] = mh.all_hosts_concat(np.full((r + 1, 2), r, np.uint32))
    gathered = mh.host0_gather(np.full((r + 1, 2), r, np.uint32))
    res["host0_gather_is_none"] = gathered is None
    if gathered is not None:
        arrays["host0_gather"] = gathered
    arrays["merge_keys"], arrays["merge_counts"] = mh.global_count_merge(
        np.asarray([[r, 0], [2, 0]], np.uint32), np.asarray([5, 7 + r]))

    # assemble at world 2, and its -kmer_occ_only branch
    result = assemble(batches, AssembleOptions(k=15), dev)
    arrays["contigs"] = canonical_contigs(result.contigs)
    res["n_contigs"] = len(result.contigs)
    occ = assemble(batches, AssembleOptions(k=15, kmer_occ_only=True), dev)
    arrays["occ_keys"], arrays["occ_counts"] = occ.kmer_table.host_words()
    arrays["occ_hist"] = occ.hist0

    # the device layer on the same local reads
    for k in (15, 21, 32, 48):
        keys, counts, hist = sharding.sharded_count(reads, k)
        arrays[f"sc{k}_keys"] = keys_to_words(keys, k)
        arrays[f"sc{k}_counts"] = counts.numpy()
        arrays[f"sc{k}_hist"] = hist.numpy()
        if k == 21:
            out, junc, n_junc, n_edge = sharding.sharded_adjacency(
                keys, counts, k)
            arrays["adj_out"], arrays["adj_junction"] = out.numpy(), \
                junc.numpy()
            res.update(adj_n_junction=n_junc, adj_n_edge=n_edge)
    codes = np.concatenate([b.codes for b in batches])
    (arrays["crs_keys"], arrays["crs_counts"],
     arrays["crs_hist"]) = sharding.count_reads_sharded(codes, 32)

    inputs = np.load(inputs_path)
    index = ContigIndex([inputs["contig0"], inputs["contig1"]],
                        key_length=32)
    half = len(inputs["map_codes"]) // n
    rows = slice(r * half, (r + 1) * half)
    ids, offs, hist = sharding.sharded_map(
        index, torch.from_numpy(inputs["map_codes"][rows]),
        torch.from_numpy(inputs["map_lengths"][rows]), 32)
    arrays["map_ids"], arrays["map_offs"] = ids.numpy(), offs.numpy()
    arrays["map_hist"] = hist.numpy()


def main() -> None:
    out_dir, inputs_path, fasta = sys.argv[1:4]
    rank = os.environ["RANK"]
    res: dict = {"ok": False}
    arrays: dict = {}
    try:
        run(inputs_path, fasta, res, arrays)
        res["ok"] = True
    except Exception:  # the parent reports it and fails the tests
        res["error"] = traceback.format_exc()
        print(res["error"], file=sys.stderr, flush=True)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    sys.exit(0 if res["ok"] else 1)


if __name__ == "__main__":
    main()
