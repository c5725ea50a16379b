"""Pairwise edit distance (counterpart of ops/align.py + ops/pallas_align.py).

``edit_distance`` is the wrapper of the hand-written CUDA kernel
``edit_distance`` (csrc/edit_distance.cu), the port of the Pallas TPU
kernel ``_bed_kernel`` (pallas_align.py:43). On a CPU tensor it runs the
plain PyTorch version below, the same anti-diagonal DP vectorised over
pairs and band; on a CUDA tensor it launches the kernel or raises.

``banded_edit_distance`` keeps the JAX wrapper's contract
(pallas_align.py:180): band rounded up to a multiple of 128 (at least 128),
empty inputs give max(len q, len t). ``edit_distance_batch`` (align.py:21,
the bubble-crush Levenshtein) calls the same kernel with a band of at
least twice the query width, which covers the whole DP matrix.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels

BIG = 1 << 28


def band_width(band: int) -> int:
    """pallas_align.py:192: at least 128, rounded up to a multiple of 128."""
    return max(128, -(-band // 128) * 128)


def edit_distance_plain(q: torch.Tensor, t: torch.Tensor, qlens: torch.Tensor,
                        tlens: torch.Tensor, bw: int,
                        width_limited: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the edit_distance kernel (same DP, same
    band placement, same BIG arithmetic as _bed_kernel).

    With `width_limited`, only the first min(bw, longest qlen) band cells
    are computed, as the kernel computes min(bw, qlen) of each pair: a cell
    past qlen is infeasible, and no cell reads further than one cell to its
    right, so the result is the same."""
    B, Lq = q.shape
    Lt = t.shape[1]
    dev = q.device
    if B == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    qlen = qlens.to(torch.int64)
    tlen = tlens.to(torch.int64)
    empty = (qlen == 0) | (tlen == 0)
    ql = torch.where(empty, 1, qlen)
    tl = torch.where(empty, 1, tlen)
    denom = torch.clamp(ql + tl - 1, min=1)
    d_last = ql + tl - 2
    half = bw // 2
    width = max(1, min(bw, int(ql.max()))) if width_limited else bw
    col = torch.arange(width, device=dev)[None, :]
    qx = q.to(torch.int64)
    tx = t.to(torch.int64)
    big_col = torch.full((B, 1), BIG, dtype=torch.int64, device=dev)
    d1 = torch.full((B, width + 3), BIG, dtype=torch.int64, device=dev)
    d2 = d1.clone()
    out = torch.full((B,), BIG, dtype=torch.int64, device=dev)

    def lo_of(d: int) -> torch.Tensor:
        ic = (max(d, 0) * ql) // denom
        return torch.clamp(ic - half, min=0)

    for d in range(int(d_last.max()) + 1):
        lo = lo_of(d)
        s1 = (lo - lo_of(d - 1))[:, None]
        s2 = (lo - lo_of(d - 2))[:, None]
        i = lo[:, None] + col
        j = d - i
        feasible = ((i <= d) & (i < ql[:, None]) & (j >= 0)
                    & (j < tl[:, None]))
        qc = qx.gather(1, i.clamp(0, max(Lq - 1, 0))) if Lq else \
            torch.full_like(i, 4)
        tc = tx.gather(1, j.clamp(0, max(Lt - 1, 0))) if Lt else \
            torch.full_like(j, 4)
        cost = torch.where((qc == tc) & (qc < 4), 0, 1)
        sub_p = d2.gather(1, col + s2)
        del_p = d1.gather(1, col + s1)
        ins_p = d1.gather(1, col + s1 + 1)
        sub_v = torch.where(i == 0, j, torch.where(j == 0, i, sub_p))
        del_v = torch.where(i == 0, j + 1, del_p)
        ins_v = torch.where(j == 0, i + 1, ins_p)
        new = torch.minimum(sub_v + cost, torch.minimum(del_v, ins_v) + 1)
        new = torch.where(feasible, new, BIG)
        r_star = (ql - 1 - lo).clamp(0, width - 1)[:, None]
        captured = new.gather(1, r_star)[:, 0]
        out = torch.where(d_last == d, captured, out)
        d2 = d1
        d1 = torch.cat([big_col, new, big_col, big_col], dim=1)
    out = torch.where(empty, torch.maximum(qlen, tlen), out)
    return out.to(torch.int32)


def edit_distance(q: torch.Tensor, t: torch.Tensor, qlens: torch.Tensor,
                  tlens: torch.Tensor, bw: int) -> torch.Tensor:
    """Banded edit distance of each row pair (the _bed_kernel contract).

    q: (B, Lq) uint8 queries padded with 4; t: (B, Lt) uint8 targets padded
    with 4 (read forward); qlens/tlens: (B,) int32 true lengths (<= Lq, Lt);
    bw: band cells. Returns (B,) int32."""
    if q.dtype != torch.uint8 or t.dtype != torch.uint8 or q.dim() != 2 \
            or t.dim() != 2 or q.shape[0] != t.shape[0]:
        raise ValueError("q and t must be (B, L) uint8 tensors")
    B = q.shape[0]
    for name, x in (("qlens", qlens), ("tlens", tlens)):
        if x.dtype != torch.int32 or tuple(x.shape) != (B,):
            raise ValueError(f"{name} must be a (B,) int32 tensor")
    if len({q.device, t.device, qlens.device, tlens.device}) != 1:
        raise ValueError("all edit_distance inputs must share one device")
    if not all(x.is_contiguous() for x in (q, t, qlens, tlens)):
        raise ValueError("edit_distance inputs must be contiguous")
    if bw < 1:
        raise ValueError("bw must be positive")
    if q.device.type == "cpu":
        return edit_distance_plain(q, t, qlens, tlens, bw)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    out = torch.empty(B, dtype=torch.int32, device=q.device)
    if B:
        kernels.edit_distance(q, t, qlens, tlens, bw, out)
    return out


def _pad_rows(seqs, device) -> tuple[torch.Tensor, torch.Tensor]:
    lens = np.array([len(s) for s in seqs], dtype=np.int32)
    width = max(int(lens.max()) if len(lens) else 0, 1)
    mat = np.full((len(seqs), width), 4, dtype=np.uint8)
    for r, s in enumerate(seqs):
        mat[r, : len(s)] = np.asarray(s, np.uint8)
    return (torch.from_numpy(mat).to(device),
            torch.from_numpy(lens).to(device))


def banded_edit_distance(queries: list[np.ndarray], targets: list[np.ndarray],
                         band: int = 128, *, device) -> np.ndarray:
    """Edit distance of each (query, target) pair within a diagonal band
    (pallas_align.py:180): exact when the optimal alignment stays inside
    the band, an upper bound otherwise. Runs on `device` (the kernel on a
    card, the plain version on the CPU). Returns (n,) int32."""
    assert len(queries) == len(targets)
    if not queries:
        return np.zeros(0, np.int32)
    q, ql = _pad_rows(queries, device)
    t, tl = _pad_rows(targets, device)
    return edit_distance(q, t, ql, tl, band_width(band)).cpu().numpy()


def edit_distance_batch(a: torch.Tensor, alen: torch.Tensor, b: torch.Tensor,
                        blen: torch.Tensor) -> torch.Tensor:
    """Levenshtein distance for each row pair (align.py:21).

    a: (P, La) uint8 codes, alen (P,) true lengths; b: (P, Lb), blen (P,).
    The band covers the whole matrix (bw >= 2 La), so the kernel's banded
    DP is exact. Codes must be bases (0..3) within the true lengths."""
    bw = band_width(2 * max(a.shape[1], 1))
    return edit_distance(a.contiguous(), b.contiguous(),
                         alen.to(torch.int32).contiguous(),
                         blen.to(torch.int32).contiguous(), bw)


def edit_distance_np(s1: np.ndarray, s2: np.ndarray) -> int:
    """Host oracle for tests (align.py:60)."""
    n, m = len(s1), len(s2)
    d = np.arange(m + 1)
    for i in range(1, n + 1):
        prev = d.copy()
        d[0] = i
        for j in range(1, m + 1):
            d[j] = min(prev[j] + 1, d[j - 1] + 1,
                       prev[j - 1] + (0 if s1[i - 1] == s2[j - 1] else 1))
    return int(d[m])
