"""Bulk exact lookup in a sorted key table (counterpart of ops/search.py).

One-lane keys (k <= 32) use ``torch.searchsorted``; keys of several lanes
use a vectorised lexicographic binary search with a fixed number of steps
(ceil(log2(n+1))), all queries advancing together.

``lookup_range`` reproduces the JAX package's ``lookup_range_jit`` step
for step (search.py:25-44,80-99), including its behaviour at the table's
end, which the mapper's outputs depend on.
"""

from __future__ import annotations

import math

import torch

from .keys import SENTINEL_LANE, lex_le, lex_lt


def _bound(table: torch.Tensor, queries: torch.Tensor, n: int,
           upper: bool) -> torch.Tensor:
    m = queries.shape[0]
    dev = queries.device
    if table.shape[1] == 1:
        return torch.searchsorted(table[:n, 0].contiguous(),
                                  queries[:, 0].contiguous(), right=upper)
    lo = torch.zeros(m, dtype=torch.int64, device=dev)
    hi = torch.full((m,), n, dtype=torch.int64, device=dev)
    for _ in range(max(1, math.ceil(math.log2(n + 1)))):
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
    for _ in range(max(1, math.ceil(math.log2(capacity + 1)))):
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


def lookup(table: torch.Tensor, queries: torch.Tensor,
           table_len: int | None = None) -> torch.Tensor:
    """Index of each query row in the sorted (N, L) table, or -1.

    Rows at index >= table_len are ignored."""
    n = table.shape[0] if table_len is None else int(table_len)
    m = queries.shape[0]
    if n == 0 or m == 0:
        return torch.full((m,), -1, dtype=torch.int64, device=queries.device)
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
    return (_bound_padded(table, queries, n, cap, upper=False),
            _bound_padded(table, queries, n, cap, upper=True))
