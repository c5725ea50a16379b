"""Bulk exact lookup in a sorted key table (counterpart of ops/search.py).

``lookup`` is a lexicographic binary search with a fixed number of steps
(ceil(log2(n+1))); its plain version searches one-lane keys (k <= 32)
with ``torch.searchsorted``.

``lookup_range`` reproduces the JAX package's ``lookup_range_jit`` step
for step (search.py:25-44,80-99), including its behaviour at the table's
end, which the mapper's outputs depend on.

``lookup_plain`` and ``lookup_range_plain`` are the plain versions (over
``_bound`` and ``_bound_padded``), all queries advancing together one step
at a time; a CPU tensor takes them. On a CUDA tensor ``lookup`` and
``lookup_range`` launch the hand-written kernel ``lex_search``
(csrc/lex_search.cu) at every key width, one lane included, or raise.
"""

from __future__ import annotations

import math

import torch

from .. import kernels
from .keys import SENTINEL_LANE, lex_le, lex_lt


def _steps(rows: int) -> int:
    return max(1, math.ceil(math.log2(rows + 1)))


def _bound(table: torch.Tensor, queries: torch.Tensor, n: int,
           upper: bool) -> torch.Tensor:
    m = queries.shape[0]
    dev = queries.device
    if table.shape[1] == 1:
        return torch.searchsorted(table[:n, 0].contiguous(),
                                  queries[:, 0].contiguous(), right=upper)
    lo = torch.zeros(m, dtype=torch.int64, device=dev)
    hi = torch.full((m,), n, dtype=torch.int64, device=dev)
    for _ in range(_steps(n)):
        active = lo < hi
        mid = (lo + hi) >> 1
        rows = table[mid.clamp(0, n - 1)]
        go_left = lex_lt(queries, rows) if upper else lex_le(queries, rows)
        hi = torch.where(active & go_left, mid, hi)
        lo = torch.where(active & ~go_left, mid + 1, lo)
    return lo


def _bound_padded(table: torch.Tensor, queries: torch.Tensor, n: int,
                  capacity: int, upper: bool) -> torch.Tensor:
    """The JAX package's _lower_bound/_upper_bound over a table of
    `capacity` rows, `n` of them live: ceil(log2(capacity+1)) steps, no
    convergence guard, row clip(mid, 0, capacity-1), every row at or past
    `n` read as the SENTINEL."""
    m = queries.shape[0]
    dev = queries.device
    lo = torch.zeros(m, dtype=torch.int64, device=dev)
    hi = torch.full((m,), n, dtype=torch.int64, device=dev)
    # against a SENTINEL row: q <= SENTINEL always, q < SENTINEL unless q
    # is the all-ones key itself
    q_lt_sent = (queries != SENTINEL_LANE).any(dim=1)
    for _ in range(_steps(capacity)):
        mid = (lo + hi) >> 1
        row = mid.clamp(0, capacity - 1)
        past = row >= n
        if n == 0:
            go_left = q_lt_sent if upper else past
        elif upper:
            rows = table[row.clamp(max=n - 1)]
            go_left = torch.where(past, q_lt_sent, lex_lt(queries, rows))
        else:
            rows = table[row.clamp(max=n - 1)]
            go_left = past | lex_le(queries, rows)
        hi = torch.where(go_left, mid, hi)
        lo = torch.where(go_left, lo, mid + 1)
    return lo


def _on_card(table: torch.Tensor, queries: torch.Tensor) -> bool:
    """True for CUDA tensors (the kernel's), False for CPU ones; raises
    for anything else."""
    if table.device != queries.device:
        raise ValueError("table and queries must share one device")
    if table.dtype != torch.int64 or queries.dtype != torch.int64 \
            or table.dim() != 2 or queries.dim() != 2 \
            or table.shape[1] != queries.shape[1]:
        raise ValueError("table (N, L) and queries (M, L) must be int64")
    if queries.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {queries.device}")
    return queries.device.type == "cuda"


def lookup(table: torch.Tensor, queries: torch.Tensor,
           table_len: int | None = None) -> torch.Tensor:
    """Index of each query row in the sorted (N, L) table, or -1.

    Rows at index >= table_len are ignored."""
    n = table.shape[0] if table_len is None else int(table_len)
    m = queries.shape[0]
    if n == 0 or m == 0:
        return torch.full((m,), -1, dtype=torch.int64, device=queries.device)
    if _on_card(table, queries):
        out = torch.empty(m, dtype=torch.int64, device=queries.device)
        kernels.lex_search(table.contiguous(), queries.contiguous(), n,
                           _steps(n), kernels.LEX_LOOKUP, out)
        return out
    return lookup_plain(table, queries, n)


def lookup_plain(table: torch.Tensor, queries: torch.Tensor,
                 n: int) -> torch.Tensor:
    """Plain version of lookup over the first n >= 1 rows."""
    pos = _bound(table, queries, n, upper=False)
    rows = table[pos.clamp(0, n - 1)]
    found = (pos < n) & (rows == queries).all(dim=1)
    return torch.where(found, pos, -1)


def contains(table: torch.Tensor, queries: torch.Tensor,
             table_len: int | None = None) -> torch.Tensor:
    return lookup(table, queries, table_len) >= 0


def lookup_range(table: torch.Tensor, queries: torch.Tensor,
                 table_len: int | None = None):
    """[lo, hi) run of a sorted-with-duplicates table equal to each query
    (search.py:103), searched as the JAX package searches it: the table's
    first `table_len` rows are live and the rest SENTINEL padding. A query
    >= the last row of an unpadded table, or equal to the all-ones
    SENTINEL, gets a bound of table_len + 1, as there."""
    cap = table.shape[0]
    n = cap if table_len is None else int(table_len)
    if queries.shape[0] == 0 or cap == 0:
        z = torch.zeros(queries.shape[0], dtype=torch.int64,
                        device=queries.device)
        return z, z.clone()
    if _on_card(table, queries):
        lo, hi = (torch.empty(queries.shape[0], dtype=torch.int64,
                              device=queries.device) for _ in range(2))
        kernels.lex_search(table.contiguous(), queries.contiguous(), n,
                           _steps(cap), kernels.LEX_RANGE, lo, hi)
        return lo, hi
    return lookup_range_plain(table, queries, n)


def lookup_range_plain(table: torch.Tensor, queries: torch.Tensor, n: int):
    """Plain version of lookup_range over a table of at least one row."""
    cap = table.shape[0]
    return (_bound_padded(table, queries, n, cap, upper=False),
            _bound_padded(table, queries, n, cap, upper=True))
