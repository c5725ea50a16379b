"""The chaining DP (counterpart of platanus_b_tpu/models/longread.py:31).

``chain_dp`` is the wrapper of the hand-written CUDA kernel ``chain_dp``
(csrc/chain_dp.cu), the port of the reference's ``_chain_kernel``: a
vmapped ``lax.fori_loop`` that XLA compiles into one device loop. On a CPU
tensor it runs the plain PyTorch version below, the same loop with the B
groups of a bucket advancing together one anchor step at a time; on a CUDA
tensor it launches the kernel (one launch a bucket) or raises.

Both read the gap cost from ops/gapcost.py's float32 table (XLA's values),
kept on each device once per max_gap.
"""

from __future__ import annotations

import functools

import torch

from .. import kernels
from .gapcost import chain_gap_cost


@functools.lru_cache(maxsize=None)
def gap_cost_table(max_gap: int, device: torch.device) -> torch.Tensor:
    """(max_gap + 1,) float32: chain_gap_cost(max_gap) on `device`."""
    return torch.from_numpy(chain_gap_cost(max_gap).copy()).to(device)


def chain_dp_plain(q: torch.Tensor, t: torch.Tensor, n: torch.Tensor, H: int,
                   max_gap: int, kk: int, gap_cost: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the chain_dp kernel (the reference's loop
    body, longread.py:38-61, over a batch of groups)."""
    B, cap = q.shape
    dev = q.device
    offs = torch.arange(1, H + 1, device=dev)
    rows = torch.arange(B, device=dev)
    f = torch.full((B, cap), float(kk), dtype=torch.float32, device=dev)
    prev = torch.full((B, cap), -1, dtype=torch.int32, device=dev)
    for i in range(1, cap):
        j = i - offs
        jc = j.clamp(0, cap - 1)
        valid = (j >= 0)[None, :] & (i < n)[:, None]
        dq = q[:, i, None] - q[:, jc]
        dt = t[:, i, None] - t[:, jc]
        ok = valid & (dq > 0) & (dt > 0) & (dq <= max_gap) \
            & (dt <= max_gap)
        gain = torch.minimum(torch.minimum(dq, dt),
                             torch.full_like(dq, kk)).to(torch.float32)
        cost = gap_cost[(dq - dt).abs().clamp(max=max_gap).long()]
        cand = torch.where(ok, f[:, jc] + gain - cost, -torch.inf)
        b = torch.argmax(cand, dim=1)
        cb = cand[rows, b]
        better = cb > f[:, i]
        f[:, i] = torch.where(better, cb, f[:, i])
        prev[:, i] = torch.where(better, jc[b].to(torch.int32),
                                 prev[:, i])
    return f, prev


def chain_dp(q: torch.Tensor, t: torch.Tensor, n: torch.Tensor, H: int,
             max_gap: int, kk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Colinear chaining DP of B anchor groups (minimap2 chain.c semantics).

    q, t: (B, cap) int32 query and target positions, each group sorted as
    _collect_groups sorts it and padded past n; n: (B,) int32 anchors a
    group; H: lookback (>= 1). Returns f (B, cap) float32, the best chain
    score ending at each anchor, and prev (B, cap) int32, its predecessor
    (-1: none)."""
    if q.dtype != torch.int32 or t.dtype != torch.int32 or q.dim() != 2 \
            or q.shape != t.shape:
        raise ValueError("q and t must be (B, cap) int32 tensors")
    B, cap = q.shape
    if n.dtype != torch.int32 or tuple(n.shape) != (B,):
        raise ValueError("n must be a (B,) int32 tensor")
    if len({q.device, t.device, n.device}) != 1:
        raise ValueError("all chain_dp inputs must share one device")
    if not all(x.is_contiguous() for x in (q, t, n)):
        raise ValueError("chain_dp inputs must be contiguous")
    if H < 1 or max_gap < 0:
        raise ValueError("H must be positive and max_gap non-negative")
    gap_cost = gap_cost_table(max_gap, q.device)
    if q.device.type == "cpu":
        return chain_dp_plain(q, t, n, H, max_gap, kk, gap_cost)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    f = torch.empty((B, cap), dtype=torch.float32, device=q.device)
    prev = torch.empty((B, cap), dtype=torch.int32, device=q.device)
    if B and cap:
        kernels.chain_dp(q, t, n, H, max_gap, kk, gap_cost, f, prev)
    return f, prev
