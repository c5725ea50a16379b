"""List ranking for the unitig labeling (counterpart of the device loops in
platanus_b_tpu/models/dbg.py:191-214 and :273-285).

``rank_from_prev`` and ``cycle_min_pair`` are the wrappers of the
hand-written CUDA kernel ``list_rank`` (csrc/list_rank.cu), the port of the
reference's ``_doubling_rank`` (a ``lax.while_loop`` whose exit test runs
on the device), run from the start state that ``_label_core`` builds from
the predecessor links, and of the cycle cut's min-pair ``lax.fori_loop``.
On a CPU tensor each runs its plain PyTorch version below, one step at a
time; on a CUDA tensor it launches the kernel, whose steps run without a
host read between them, or raises.

All arrays are (m,) int64 over oriented node ids: ``ptr`` a pointer to
another id, or -1 where the pointer has died. On the card the kernel packs
an id's state into 32-bit fields, so it takes m < 2^30 ids, at most 30
steps, and pointers in [-1, m) (min pairs in [0, 2^31)), as the labeling
gives them.
"""

from __future__ import annotations

import torch

from .. import kernels


def doubling_rank_plain(ptr: torch.Tensor, rank: torch.Tensor,
                        anchor: torch.Tensor, iters: int):
    """dbg.py:191: pointer-doubling list ranking, leaving the loop once
    every pointer has died (one host sync per step); `iters` caps it.
    Cycle members never die. Returns (ptr, rank, anchor, the steps that
    did work)."""
    m = ptr.shape[0]
    steps = 0
    for _ in range(iters):
        has = ptr >= 0
        if not bool(has.any()):
            break
        p = ptr.clamp(0, m - 1)
        rank = torch.where(has, rank + rank[p], rank)
        anchor = torch.where(has, anchor[p], anchor)
        ptr = torch.where(has, ptr[p], ptr)
        steps += 1
    return ptr, rank, anchor, steps


def cycle_min_pair_plain(ptr: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                         iters: int):
    """dbg.py:273-285: `iters` doubling steps that carry the
    lexicographically smallest (a, b) pair along each pointer chain; no
    early exit. Returns (a, b)."""
    m = ptr.shape[0]
    for _ in range(iters):
        has = ptr >= 0
        pp = ptr.clamp(0, m - 1)
        ap, bp = a[pp], b[pp]
        better = has & ((ap < a) | ((ap == a) & (bp < b)))
        a = torch.where(better, ap, a)
        b = torch.where(better, bp, b)
        ptr = torch.where(has, ptr[pp], ptr)
    return a, b


def rank_from_prev_plain(prv: torch.Tensor, iters: int):
    """dbg.py:254-256 then :191: the start state of the labeling's ranking
    (rank 1 and anchor prv where prv is live, else rank 0 and the id
    itself) and doubling_rank_plain from it."""
    arange = torch.arange(prv.shape[0], device=prv.device)
    rank0 = torch.where(prv >= 0, 1, 0)
    anchor0 = torch.where(prv >= 0, prv, arange)
    return doubling_rank_plain(prv, rank0, anchor0, iters)


def _check(iters: int, *xs: torch.Tensor) -> str:
    if iters < 1:
        raise ValueError("list ranking takes at least one step")
    m = xs[0].shape[0]
    for x in xs:
        if x.dtype != torch.int64 or x.dim() != 1 or x.shape[0] != m:
            raise ValueError("list ranking takes (m,) int64 tensors")
    if len({x.device for x in xs}) != 1:
        raise ValueError("list ranking inputs must share one device")
    dev = xs[0].device.type
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {xs[0].device}")
    if dev == "cuda" and (m >= 1 << 30 or iters > 30):
        raise ValueError("list_rank takes fewer than 2^30 ids and at most "
                         f"30 steps on the card (m {m}, iters {iters})")
    return dev


def rank_from_prev(prv: torch.Tensor, iters: int):
    """List ranking by pointer doubling from the predecessor links prv, at
    most `iters` steps, stopping once no pointer is live. Returns (ptr,
    rank, anchor, stats): stats is a (2,) int64 tensor on prv's device
    holding the steps that did work and 1 if a pointer is still live (a
    cycle, or a binding cap), else 0. On the card, reading stats is the
    only host sync."""
    if _check(iters, prv) == "cpu":
        ptr, rank, anchor, steps = rank_from_prev_plain(prv, iters)
        live = int(bool((ptr >= 0).any()))
        return ptr, rank, anchor, torch.tensor([steps, live])
    outs = [torch.empty_like(prv, memory_format=torch.contiguous_format)
            for _ in range(3)]
    stats = torch.empty(2, dtype=torch.int64, device=prv.device)
    kernels.list_rank(prv.contiguous(), iters, *outs, stats)
    return (*outs, stats)


def cycle_min_pair(ptr: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                   iters: int):
    """The smallest (a, b) pair along each pointer chain after `iters`
    doubling steps. Returns (a, b)."""
    if _check(iters, ptr, a, b) == "cpu":
        return cycle_min_pair_plain(ptr, a, b, iters)
    a_out, b_out = (torch.empty_like(a, memory_format=torch.contiguous_format)
                    for _ in range(2))
    kernels.min_pair(ptr.contiguous(), a.contiguous(), b.contiguous(), iters,
                     a_out, b_out)
    return a_out, b_out
