"""Multi-process runtime: torch.distributed bring-up, ingest sharding, host
gathers (counterpart of platanus_b_tpu/parallel/multihost.py).

- `initialize()` brings up the default process group from torchrun's
  environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK; LOCAL_RANK picks
  the card, device.py); without it the run is single-process;
- `host_shard(items)` / `host_read_plan(paths)` give each rank its slice of
  the read files, whole or by byte range at record boundaries;
- `host0_gather`, `all_hosts_concat`, `broadcast_from_host0`,
  `global_count_merge`, `global_count_merge_sharded` and `psum_histogram`
  move per-rank numpy results between ranks.

The host layer keeps the JAX package's contract: numpy in, numpy out. Its
collectives move CPU tensors, which the default group hands to gloo
(backend "cpu:gloo,cuda:nccl", or "gloo" alone when the CPU is asked for),
so several ranks may share one card: no collective here touches CUDA.
Arrays travel as their raw bytes, so every dtype arrives exactly. Every
function is the identity at one process. A failed collective raises, and
the rank that sees it exits non-zero; nothing falls back.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..device import ENV_VAR
from ..ops.count import MAX_OCCURRENCE

# torchrun's variables, in the place of JAX_COORDINATOR_ADDRESS,
# JAX_NUM_PROCESSES and JAX_PROCESS_ID
ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def initialize() -> bool:
    """Initialize the default process group when torchrun's environment is
    set. Returns True when this call initialized it, False for a
    single-process run (or a group someone else initialized)."""
    if dist.is_initialized() or not all(os.environ.get(v) for v in ENV):
        return False
    cpu = os.environ.get(ENV_VAR, "").strip().lower() == "cpu"
    backend = ("gloo" if cpu or not torch.cuda.is_available()
               else "cpu:gloo,cuda:nccl")
    dist.init_process_group(backend=backend, init_method="env://")
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def host_shard(items: Sequence, index: int | None = None,
               count: int | None = None) -> list:
    """Round-robin slice of `items` owned by this rank: a pure function of
    (index, count), so no coordination is needed."""
    i = process_index() if index is None else index
    n = process_count() if count is None else count
    return list(items[i::n])


def host_read_plan(paths: Sequence[str], min_chunk: int = 64 << 20,
                   index: int | None = None,
                   count: int | None = None) -> list[tuple[str, int, int]]:
    """(path, byte_start, byte_end) ranges owned by this rank.

    Files larger than `min_chunk` are split into `count` byte ranges; the
    reader scans forward from byte_start to the next record and reads
    through the record straddling byte_end, so the ranges partition the
    records wherever the cuts land. Smaller files go whole, round-robin."""
    i = process_index() if index is None else index
    n = process_count() if count is None else count
    plan: list[tuple[str, int, int]] = []
    small: list[str] = []
    for p in paths:
        try:
            size = os.path.getsize(p)
        except OSError:
            size = 0
        if n > 1 and size > min_chunk:
            per = -(-size // n)  # ceil
            start, end = i * per, min((i + 1) * per, size)
            if start < size:
                plan.append((p, start, end))
        else:
            small.append(p)
    plan.extend((p, 0, -1) for p in host_shard(small, i, n))
    return plan


def _bytes_of(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).reshape(-1)
                            .view(np.uint8).copy())


def _rows_of(raw: torch.Tensor, like: np.ndarray) -> np.ndarray:
    return raw.numpy().view(like.dtype).reshape((-1,) + like.shape[1:])


def _allgather_int64(values: np.ndarray) -> np.ndarray:
    """(n, len(values)) int64: every rank's `values`, in rank order."""
    t = torch.from_numpy(np.asarray(values, np.int64).reshape(-1).copy())
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t)
    return torch.stack(out).numpy()


def _ragged_allgather(x: np.ndarray) -> list[np.ndarray]:
    """Every rank's rows of `x`, whose row count differs per rank: the row
    counts first, then the bytes padded to the longest."""
    x = np.asarray(x)
    lens = _allgather_int64([x.shape[0]])[:, 0]
    row = x.dtype.itemsize * int(np.prod(x.shape[1:], dtype=np.int64))
    n_max = max(int(lens.max()) * row, 1)
    raw = _bytes_of(x)
    send = torch.zeros(n_max, dtype=torch.uint8)
    send[: raw.numel()] = raw
    out = [torch.empty_like(send) for _ in range(len(lens))]
    dist.all_gather(out, send)
    return [_rows_of(o[: int(n) * row], x) for o, n in zip(out, lens)]


def host0_gather(x: np.ndarray) -> np.ndarray | None:
    """Concatenation of every rank's rows on rank 0 (None elsewhere)."""
    if process_count() == 1:
        return np.asarray(x)
    out = np.concatenate(_ragged_allgather(x), axis=0)
    return out if process_index() == 0 else None


def all_hosts_concat(x: np.ndarray) -> np.ndarray:
    """Concatenation of every rank's rows, replicated to all ranks."""
    if process_count() == 1:
        return np.asarray(x)
    return np.concatenate(_ragged_allgather(x), axis=0)


def broadcast_from_host0(x: np.ndarray) -> np.ndarray:
    """Rank 0's value (e.g. a chosen cutoff) on every rank; every rank
    passes an array of the same shape and dtype."""
    x = np.asarray(x)
    if process_count() == 1:
        return x
    t = _bytes_of(x)
    dist.broadcast(t, src=0)
    return t.numpy().view(x.dtype).reshape(x.shape)


def _reduce_by_key(keys: np.ndarray, counts: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Sort rows by key (lexicographic over words) and sum equal keys'
    counts, saturating at MAX_OCCURRENCE."""
    if len(keys) == 0:
        return keys, counts.astype(np.uint32)
    order = np.lexsort(tuple(keys[:, w]
                             for w in range(keys.shape[1] - 1, -1, -1)))
    keys, counts = keys[order], counts[order]
    new_run = np.empty(len(keys), dtype=bool)
    new_run[0] = True
    new_run[1:] = (keys[1:] != keys[:-1]).any(axis=1)
    starts = np.flatnonzero(new_run)
    summed = np.add.reduceat(counts, starts)
    return keys[starts], np.minimum(summed, MAX_OCCURRENCE).astype(np.uint32)


def global_count_merge(keys: np.ndarray, counts: np.ndarray
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Merge per-rank sorted k-mer tables ((N, W) uint32 words, counts)
    into the global table, replicated on every rank. Counts saturate at
    the reference's u16 cap (counter.h:459-476). Single-process it still
    canonicalizes (idempotent on a deduped table)."""
    keys = np.asarray(keys)
    counts = np.asarray(counts, np.uint64)
    if process_count() > 1:
        keys = all_hosts_concat(keys)
        counts = all_hosts_concat(counts)
    return _reduce_by_key(keys, counts)


def shard_range_of(keys: np.ndarray, count: int | None = None,
                   k: int | None = None) -> np.ndarray:
    """Destination rank of each sorted-key row: contiguous ranges of word 0,
    so every shard is a sorted slice of the global table and the shards
    concatenate in rank order into it. `k` fixes the used bits of word 0
    (for k < 16 the value is left-aligned before splitting)."""
    n = process_count() if count is None else count
    top = np.asarray(keys)[:, 0].astype(np.uint64)
    used = 32 if k is None else min(2 * k, 32)
    top = top << np.uint64(32 - used)
    return (top * np.uint64(n) >> np.uint64(32)).astype(np.int64)


def global_count_merge_sharded(keys: np.ndarray, counts: np.ndarray,
                               k: int | None = None
                               ) -> tuple[np.ndarray, np.ndarray]:
    """Key-range-sharded merge: this rank ends with ONLY its contiguous
    key-range shard of the global table (shard_range_of), so no rank
    holds the whole raw table. Rows reach their owners in one
    all_to_all (_all_to_all_exchange). Single-process it dedups locally.
    A failed exchange raises; there is no slower fallback."""
    keys = np.asarray(keys)
    counts = np.asarray(counts, np.uint64)
    n = process_count()
    if n == 1:
        return _reduce_by_key(keys, counts)
    dest = shard_range_of(keys, n, k)
    order = np.argsort(dest, kind="stable")
    dest_counts = np.bincount(dest, minlength=n).astype(np.int64)
    payload = np.concatenate(
        [keys[order].astype(np.uint32),
         np.minimum(counts[order], MAX_OCCURRENCE).astype(np.uint32)[:, None]],
        axis=1)
    mine = _all_to_all_exchange(payload, dest_counts)
    return _reduce_by_key(mine[:, :-1].astype(keys.dtype),
                          mine[:, -1].astype(np.uint64))


def _all_to_all_exchange(payload: np.ndarray,
                         dest_counts: np.ndarray) -> np.ndarray:
    """Route payload rows (grouped by destination, dest_counts rows each)
    to their ranks with ONE all_to_all_single of exact split sizes; the
    n x n count matrix goes first, so nothing is capped. Returns this
    rank's received rows, in source-rank order."""
    i, n = process_index(), process_count()
    C = _allgather_int64(dest_counts).reshape(n, n)
    row = payload.shape[1] * payload.dtype.itemsize
    recv = torch.empty(int(C[:, i].sum()) * row, dtype=torch.uint8)
    dist.all_to_all_single(recv, _bytes_of(payload),
                           output_split_sizes=[int(c) * row for c in C[:, i]],
                           input_split_sizes=[int(c) * row
                                              for c in dest_counts])
    return _rows_of(recv, payload)


def psum_histogram(local: np.ndarray) -> np.ndarray:
    """Elementwise sum over ranks (int64, or float64 for float input), so
    every rank derives the same cutoff from the global distribution
    (counter.h:245-267)."""
    local = np.asarray(local)
    if process_count() == 1:
        return local
    dt = np.float64 if local.dtype.kind == "f" else np.int64
    t = torch.from_numpy(local.astype(dt))
    dist.all_reduce(t)
    return t.numpy()
