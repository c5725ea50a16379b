"""List ranking for the unitig labeling (counterpart of the device loops in
platanus_b_tpu/models/dbg.py:191-214 and :273-285).

``doubling_rank`` and ``cycle_min_pair`` are the wrappers of the
hand-written CUDA kernel ``list_rank`` (csrc/list_rank.cu), the port of the
reference's ``_doubling_rank`` (a ``lax.while_loop`` whose exit test runs
on the device) and of the cycle cut's min-pair ``lax.fori_loop``. On a CPU
tensor each runs its plain PyTorch version below, one step at a time; on a
CUDA tensor it launches the kernel, whose steps run without a host read
between them, or raises.

All arrays are (m,) int64 over oriented node ids: ``ptr`` a pointer to
another id, or -1 where the pointer has died.
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
    return dev


def doubling_rank(ptr: torch.Tensor, rank: torch.Tensor,
                  anchor: torch.Tensor, iters: int):
    """List ranking by pointer doubling, at most `iters` steps, stopping
    once no pointer is live. Returns (ptr, rank, anchor, stats): stats is
    a (2,) int64 tensor on the inputs' device holding the steps that did
    work and 1 if a pointer is still live (a cycle, or a binding cap),
    else 0. On the card, reading stats is the only host sync."""
    if _check(iters, ptr, rank, anchor) == "cpu":
        ptr, rank, anchor, steps = doubling_rank_plain(ptr, rank, anchor,
                                                       iters)
        live = int(bool((ptr >= 0).any()))
        return ptr, rank, anchor, torch.tensor([steps, live])
    bufs = [x.clone(memory_format=torch.contiguous_format)
            for x in (ptr, rank, anchor)]
    scratch = [torch.empty_like(x) for x in bufs]
    stats = torch.empty(2, dtype=torch.int64, device=ptr.device)
    kernels.list_rank(bufs, scratch, iters, stats)
    return (*bufs, stats)


def cycle_min_pair(ptr: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                   iters: int):
    """The smallest (a, b) pair along each pointer chain after `iters`
    doubling steps. Returns (a, b)."""
    if _check(iters, ptr, a, b) == "cpu":
        return cycle_min_pair_plain(ptr, a, b, iters)
    bufs = [x.clone(memory_format=torch.contiguous_format)
            for x in (ptr, a, b)]
    scratch = [torch.empty_like(x) for x in bufs]
    kernels.min_pair(bufs, scratch, iters)
    # step s reads buffer s % 2 and writes the other one
    out = bufs if iters % 2 == 0 else scratch
    return out[1], out[2]
