"""Key-space-sharded k-mer data plane over a process group (counterpart of
platanus_b_tpu/parallel/sharding.py).

- reads are data-parallel over the ranks: each rank extracts the canonical
  k-mers of its own slice with the kmer_extract kernel (ops/kmer.py);
- the k-mer table is key-space-sharded: key x belongs to rank
  ``mw_hash(x) % n``, the JAX package's owner rule on the same uint32
  words (ops/minimizer.py:mw_hash), so both packages give each rank the
  same shard;
- the shuffle from read order to owner order is ONE ``all_to_all_single``
  with exact split sizes, which are exchanged first. The JAX package's
  ``cap_per_dest`` and ``dropped`` (a fixed-shape buffer and the count of
  keys that overflowed it) have no counterpart: nothing is dropped;
- histograms and totals are ``all_reduce`` sums.

Every function takes the rank's local slice and a process group (None:
the default group). The collectives run on the tensors' device: CUDA
tensors over the group's NCCL backend, CPU tensors over gloo. The JAX
package's ``make_mesh`` has no counterpart: the process group takes its
place. Sorting and deduplication are the port's counting path
(ops/count.py), so counts saturate at MAX_OCCURRENCE like
count_reads_device's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..device import select_device
from ..io.reads import ReadBatch
from ..models.assemble_core import StagedReads, stage_reads
from ..models.dbg import popcount4
from ..models.mapper import MAX_CANDIDATES, READ_CHUNK, ContigIndex, _map_chunk
from ..ops import count as cnt
from ..ops.keys import (canonical_words, is_sentinel, keys_to_words,
                        lanes_to_words, num_lanes, num_words, revcomp_words,
                        shl2_words, sort_keys, words_to_lanes)
from ..ops.minimizer import mw_hash
from ..ops.search import lookup


def _exchange(rows: torch.Tensor, owner: torch.Tensor, n: int, group):
    """Send each row to rank owner[row] with one all_to_all_single.

    Returns (received rows in source-rank order, the permutation that
    grouped the sent rows by owner, send split sizes, receive split
    sizes); the splits, swapped, route answers back (sharded_adjacency)."""
    order = torch.argsort(owner, stable=True)
    send_counts = torch.bincount(owner, minlength=n)
    recv_counts = torch.empty_like(send_counts)
    dist.all_to_all_single(recv_counts, send_counts, group=group)
    sent, got = send_counts.tolist(), recv_counts.tolist()
    recv = rows.new_empty((sum(got),) + tuple(rows.shape[1:]))
    dist.all_to_all_single(recv, rows[order].contiguous(),
                           output_split_sizes=got, input_split_sizes=sent,
                           group=group)
    return recv, order, sent, got


def all_gather_rows(t: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's rows of `t` (row counts may differ), in rank order."""
    n = dist.get_world_size(group)
    size = torch.tensor([t.shape[0]], dtype=torch.int64, device=t.device)
    sizes = [torch.empty_like(size) for _ in range(n)]
    dist.all_gather(sizes, size, group=group)
    sizes = [int(s) for s in sizes]
    pad = t.new_zeros((max(max(sizes), 1),) + tuple(t.shape[1:]))
    pad[: t.shape[0]] = t
    out = [torch.empty_like(pad) for _ in range(n)]
    dist.all_gather(out, pad, group=group)
    return [o[:s] for o, s in zip(out, sizes)]


def sharded_count(reads: StagedReads, k: int, group=None):
    """Count the canonical k-mers of every rank's reads into key-space
    shards (sharding.py:76 sharded_count_fn).

    Returns this rank's shard, (keys (n, L) int64 lanes sorted, counts (n,)
    int64), and the global occurrence histogram (MAX_OCCURRENCE + 1,)
    int64, on the reads' device. A rank with no reads still takes part."""
    n = dist.get_world_size(group)
    L = num_lanes(k)
    if reads.num_reads and reads.max_len >= k:
        keys, _n_valid = reads.kmers(k)
        flat = keys.reshape(-1, L)
        del keys
        flat = flat[~is_sentinel(flat)]
    else:
        flat = torch.zeros((0, L), dtype=torch.int64, device=reads.device)
    owner = mw_hash(lanes_to_words(flat, num_words(k))) % n
    recv, _order, _sent, _got = _exchange(flat, owner, n, group)
    del flat, owner
    keys, counts, _n = cnt.count_lanes_fused(recv)
    hist = cnt.occurrence_histogram(counts)
    dist.all_reduce(hist, group=group)
    return keys, counts, hist


def count_reads_sharded(codes: np.ndarray, k: int, group=None):
    """Host wrapper (sharding.py:117): count this rank's (R, L) uint8 code
    rows (4 = N or padding) with sharded_count on the rank's device
    (device.select_device: its card, or the CPU when asked for), then
    gather every shard and sort them into the global table. Returns (keys
    (N, W) uint32 words, counts (N,) uint32, histogram (MAX_OCCURRENCE + 1,)
    int32), the same on every rank."""
    codes = np.ascontiguousarray(codes, np.uint8)
    R, Lc = codes.shape
    reads = stage_reads([ReadBatch(codes, np.full(R, Lc, np.int32))],
                        select_device())
    keys, counts, hist = sharded_count(reads, k, group)
    all_k = torch.cat(all_gather_rows(keys, group))
    all_c = torch.cat(all_gather_rows(counts, group))
    all_k, all_c = sort_keys(all_k, all_c)
    return (keys_to_words(all_k, k), all_c.cpu().numpy().astype(np.uint32),
            cnt.histogram_host(hist))


def sharded_adjacency(keys: torch.Tensor, counts: torch.Tensor, k: int,
                      group=None):
    """Adjacency of a key-space-sharded graph by a halo exchange of lookups
    (sharding.py:148 sharded_adjacency_fn; the neighbour rule of
    models/dbg.py:_adjacency). Every alive key of this rank's shard makes
    its 8 canonical neighbour queries (2 orientations x 4 bases); each
    query goes to its owner, which answers it by binary search in its
    shard, and the answer comes back by the inverse exchange.

    Returns (out (n, 2) uint8 nibbles of existing neighbours, is_junction
    (n,) bool, n_junction and n_edge summed over the ranks)."""
    n = dist.get_world_size(group)
    m = keys.shape[0]
    alive = counts > 0
    words = lanes_to_words(keys, num_words(k))
    queries = []
    for o in (0, 1):
        shifted = shl2_words(words if o == 0 else revcomp_words(words, k), k)
        for b in range(4):
            q = shifted.clone()
            q[:, -1] |= b
            queries.append(canonical_words(q, k)[0])
    asked = alive.repeat(8)                  # query (o, b, node) of an alive node
    q_words = torch.cat(queries)[asked]
    owner = mw_hash(q_words) % n
    recv, order, sent, got = _exchange(words_to_lanes(q_words), owner, n,
                                       group)
    idx = lookup(keys, recv)
    found = idx >= 0
    if m:
        found &= alive[idx.clamp(min=0)]
    ans = found.to(torch.uint8)
    back = torch.empty(sum(sent), dtype=torch.uint8, device=keys.device)
    dist.all_to_all_single(back, ans, output_split_sizes=sent,
                           input_split_sizes=got, group=group)
    hit = torch.zeros(q_words.shape[0], dtype=torch.bool, device=keys.device)
    hit[order] = back.bool()
    exists = torch.zeros(8 * m, dtype=torch.bool, device=keys.device)
    exists[asked] = hit
    exists = exists.reshape(2, 4, m).permute(2, 0, 1)
    bits = 1 << torch.arange(4, device=keys.device)
    out = torch.where(exists, bits, 0).sum(dim=-1).to(torch.uint8)
    outdeg = popcount4(out)
    is_junction = alive & ((outdeg[:, 0] >= 2) | (outdeg[:, 1] >= 2))
    totals = torch.stack([is_junction.sum(),
                          torch.where(alive[:, None], outdeg, 0).sum()])
    dist.all_reduce(totals, group=group)
    return out, is_junction, int(totals[0]), int(totals[1])


def sharded_map(index: ContigIndex, codes: torch.Tensor,
                lengths: torch.Tensor, word_len: int, group=None):
    """Data-parallel read mapping (sharding.py:256 sharded_map_fn): this
    rank's reads against a replicated contig index with the seed-vote map
    (models/mapper.py:_map_chunk), and the per-contig mapped-read
    histogram summed over the ranks.

    Returns (ids (R,) int32, offsets (R,) int32, hist (C,) int64) on the
    index's device; an id is +-(contig + 1), 0 when the read is unmapped."""
    R, Lc = codes.shape
    S = max(-(-Lc // word_len) + 1, 1)
    ids = torch.zeros(R, dtype=torch.int64, device=index.device)
    offs = torch.zeros(R, dtype=torch.int64, device=index.device)
    for r0 in range(0, R, READ_CHUNK):
        ids[r0: r0 + READ_CHUNK], offs[r0: r0 + READ_CHUNK] = _map_chunk(
            index, codes[r0: r0 + READ_CHUNK], lengths[r0: r0 + READ_CHUNK],
            word_len, S, MAX_CANDIDATES)
    C = index.num_contigs
    contig = torch.where(ids != 0, ids.abs() - 1, C)
    hist = torch.bincount(contig, minlength=C + 1)[:C]
    dist.all_reduce(hist, group=group)
    return ids.to(torch.int32), offs.to(torch.int32), hist
