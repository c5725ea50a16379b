"""The chaining DP's gap cost as a float32 table (models/longread.py).

The JAX package's chaining kernel (platanus_b_tpu/models/longread.py:51-52)
scores a gap of g bases as ``g * 0.1 + where(g > 0, log2(g + 1) * 0.5, 0)``
in float32. XLA's CPU backend folds ``log2(x) * 0.5`` into
``log(x) * 0.72134751``, evaluates ``log`` with the Cephes polynomial of
its CPU runtime and contracts ``g * 0.1 + ...`` into one fused multiply-add,
so its last bits differ from the same expression in torch (on the CPU and
on a card) for about a quarter of all g. A flipped last bit can flip a
near-tie between two predecessors, and with it the chain and the PAF
``AS`` field.

g is an integer in [0, max_gap], so the port evaluates XLA's sequence of
float32 operations once per max_gap, here in numpy, and the DP gathers the
cost by g. The table lives on the host, and ops/chain.py keeps a copy on
each device that chains; every device then reads the same bits.
"""

from __future__ import annotations

import functools

import numpy as np

_F = np.float32
# Cephes logf coefficients, as XLA's CPU runtime uses them
_P = tuple(_F(v) for v in (7.0376836292e-2, -1.1514610310e-1,
                           1.1676998740e-1, -1.2420140846e-1,
                           1.4249322787e-1, -1.6668057665e-1,
                           2.0000714765e-1, -2.4999993993e-1,
                           3.3333331174e-1))
_SQRTHF = _F(0.707106781186547524)
_Q1 = _F(-2.12194440e-4)
_Q2 = _F(0.693359375)
# 0.5 / log(2) after XLA's constant folding of log2(x) * 0.5
_HALF_OVER_LN2 = _F(0.721347511)


def xla_cpu_log(x: np.ndarray) -> np.ndarray:
    """float32 natural log of positive normal x, operation for operation as
    XLA's CPU backend computes it (range reduction to [sqrt(1/2), sqrt(2)),
    a degree-9 polynomial, separate multiplies and adds)."""
    x = np.asarray(x, _F)
    bits = x.view(np.uint32)
    e = _F(1) + ((bits >> 23).astype(np.int32) - 0x7F).astype(_F)
    m = ((bits & np.uint32(0x807FFFFF)) | _F(0.5).view(np.uint32)).view(_F)
    small = m < _SQRTHF
    tmp = np.where(small, m, _F(0))
    m = m - _F(1)
    e = e - np.where(small, _F(1), _F(0))
    m = m + tmp
    m2 = m * m
    m3 = m2 * m
    y = m * _P[0] + _P[1]
    y1 = m * _P[3] + _P[4]
    y2 = m * _P[6] + _P[7]
    y = y * m + _P[2]
    y1 = y1 * m + _P[5]
    y2 = y2 * m + _P[8]
    y = y * m3 + y1
    y = y * m3 + y2
    y = y * m3
    y = y + _Q1 * e
    m = m - m2 * _F(0.5)
    m = m + y
    return m + _Q2 * e


@functools.lru_cache(maxsize=None)
def chain_gap_cost(max_gap: int) -> np.ndarray:
    """(max_gap + 1,) float32: the reference's gap cost of g = 0..max_gap.
    The last step is XLA's fused multiply-add: g * 0.1 is exact in float64
    (g < 2**29), so one float64 add and the cast to float32 round it. The
    table equals XLA's values on every g in [0, 10000]
    (tests/test_torch_longread_cli.py)."""
    g = np.arange(max_gap + 1, dtype=_F)
    log_term = np.where(g > 0, xla_cpu_log(g + _F(1)) * _HALF_OVER_LN2, _F(0))
    out = (g.astype(np.float64) * np.float64(_F(0.1))
           + log_term.astype(np.float64)).astype(_F)
    out.flags.writeable = False
    return out
