"""Minimizer sketching (counterpart of platanus_b_tpu/ops/minimizer.py).

For every window of w consecutive k-mers, the canonical k-mer with the
smallest mixed hash is a minimizer (minimap2/sketch.c:143). The canonical
and forward k-mers of the whole padded batch come from the ``kmer_extract``
kernel (a CPU tensor takes its plain version); the hash, the sliding-window
minimum and the marks are torch ops on the same device.

Strand convention matches minimap2: a minimizer records whether the
canonical (smaller) form was the forward or reverse-complement k-mer.
"""

from __future__ import annotations

import numpy as np
import torch

from .keys import MASK32, lanes_to_words, lex_eq, num_words
from .kmer import extract_kmers_packed, pack_codes

HASH_INVALID = 0xFFFFFFFF


def _mul32(v: torch.Tensor, c: int) -> torch.Tensor:
    """(v * c) mod 2^32 for int64 v in [0, 2^32), without int64 overflow."""
    lo = v * (c & 0xFFFF)
    hi = ((v * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def mw_hash(words: torch.Tensor) -> torch.Tensor:
    """multiword.py:138 mw_hash on (..., W) int64 words holding u32 values:
    Murmur3 finalizer per word, combined as h = h * 0x9E3779B1 ^ v."""
    h = torch.zeros(words.shape[:-1], dtype=torch.int64, device=words.device)
    for w in range(words.shape[-1]):
        v = words[..., w]
        v = v ^ (v >> 16)
        v = _mul32(v, 0x85EBCA6B)
        v = v ^ (v >> 13)
        v = _mul32(v, 0xC2B2AE35)
        v = v ^ (v >> 16)
        h = _mul32(h, 0x9E3779B1) ^ v
    return h


def minimizer_positions(codes: torch.Tensor, k: int, w: int):
    """Minimizer mask over a padded (R, L) uint8 batch, L a multiple of 32
    (minimizer.py:28). Returns (hash (R, P) int64 holding u32 values,
    is_min (R, P) bool, strand (R, P) uint8 0=fwd/1=rev, valid (R, P)
    bool), P = L - k + 1; a position is a minimizer iff its hash equals the
    minimum of any w-window containing it."""
    R, L = codes.shape
    words, nmask = pack_codes(codes)
    keys, _n = extract_kmers_packed(words, k, nmask=nmask, max_len=L)
    fkeys, _n = extract_kmers_packed(words, k, nmask=nmask, max_len=L,
                                     forward_only=True)
    P = keys.shape[1]
    is_n = (codes > 3).to(torch.int32)
    csum = torch.nn.functional.pad(torch.cumsum(is_n, dim=1), (1, 0))
    valid = (csum[:, k:k + P] - csum[:, :P]) == 0
    strand = torch.where(lex_eq(keys, fkeys), 0, 1).to(torch.uint8)
    h = mw_hash(lanes_to_words(keys, num_words(k)))
    h = torch.where(valid, h, HASH_INVALID)
    if P < w:
        return h, valid, strand, valid
    wmin = h.unfold(1, w, 1).amin(dim=-1)          # (R, S) window minima
    S = wmin.shape[1]
    marks = torch.zeros((R, P), dtype=torch.bool, device=codes.device)
    for off in range(w):
        marks[:, off: off + S] |= h[:, off: off + S] == wmin
    return h, marks & valid, strand, valid


def sketch(codes: np.ndarray, lengths: np.ndarray, k: int, w: int,
           device="cpu"):
    """Per-read minimizer lists (minimizer.py:65): a list of (hash (M,)
    uint32, pos (M,) int32, strand (M,) uint8) numpy arrays."""
    h, is_min, strand, _valid = minimizer_positions(
        torch.from_numpy(np.ascontiguousarray(codes, np.uint8)).to(device),
        k, w)
    h = h.cpu().numpy().astype(np.uint32)
    is_min = is_min.cpu().numpy()
    strand = strand.cpu().numpy()
    out = []
    for r in range(codes.shape[0]):
        n = max(int(lengths[r]) - k + 1, 0)
        sel = np.nonzero(is_min[r, :n])[0]
        out.append((h[r, sel], sel.astype(np.int32), strand[r, sel]))
    return out
