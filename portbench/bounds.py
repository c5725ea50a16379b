"""The card's peak and the bytes each hand-written kernel needs for one
call, from the shapes of the call (the rule of `chip_smoke.py`'s kernel
bounds): each input read once and each output written once, whatever the
kernel reads again. A kernel's share of its roofline is these bytes over
HBM_BYTES_S, divided by the kernel's device time.

Each function takes the arguments of the port's launcher of the same name
in `platanus_b_tpu_torch/kernels.py`, exactly as the launcher gets them.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, at 700 W: HBM3 bytes a second
HBM_BYTES_S = 3.35e12


def _nbytes(t) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def kmer_extract(words, nmask, lengths, k, P, forward_only, out, n_valid):
    """K2: the packed reads (and their N mask or lengths) in, every
    window's key lanes and the valid count out."""
    return (_nbytes(words) + _nbytes(nmask) + _nbytes(lengths)
            + _nbytes(out) + _nbytes(n_valid))


def list_rank(prv, iters, ptr, rank, anchor, stats):
    """K5's doubling: the predecessor links in; ptr, rank and anchor out
    (8 bytes each an id)."""
    return 32 * prv.shape[0]


def min_pair(ptr, a, b, iters, a_out, b_out):
    """K5's min-pair steps: ptr, a and b in; the two minima out."""
    return 40 * ptr.shape[0]


def lex_search(table, queries, n, steps, mode, out0, out1=None):
    """K6: the table's live rows and the queries in, one int64 an output
    a query out (two in range mode)."""
    M, L = queries.shape
    outs = 2 if out1 is not None else 1
    return 8 * (L * (int(n) + M) + outs * M)


def unitig_sum(uid, counts, num_u, out, ulen=None, stats=None):
    """K7: uid and counts in (int64), the float32 sums out, and ulen
    (int64) where asked."""
    return 16 * uid.shape[0] + 4 * int(num_u) + (8 * int(num_u)
                                                  if ulen is not None else 0)


BYTES = {"kmer_extract": kmer_extract, "list_rank": list_rank,
         "min_pair": min_pair, "lex_search": lex_search,
         "unitig_sum": unitig_sum}
