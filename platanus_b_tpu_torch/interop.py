"""State carried between the JAX package and the port (tests, tools).

Keys cross as the JAX package's (N, W) uint32 words <-> the port's
(N, L) int64 lanes, order preserved (ops/keys.py). A graph or a k-mer
table crosses as the numpy arrays of its live rows, which the caller pulls
from the JAX package's objects; this module itself needs only numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.assemble_core import KmerTable
from .models.dbg import DBG
from .models.mapper import ContigIndex
from .ops.keys import keys_from_words, keys_to_words

__all__ = ["keys_from_words", "keys_to_words", "contig_index_from_arrays",
           "dbg_from_arrays", "kmer_table_from_arrays"]


def kmer_table_from_arrays(k: int, words: np.ndarray, counts: np.ndarray,
                           device="cpu") -> KmerTable:
    """Port table from a JAX KmerTable's live (n, W) u32 keys + counts."""
    return KmerTable(k, keys_from_words(words, device),
                     torch.from_numpy(np.asarray(counts, np.int64)).to(device))


def dbg_from_arrays(k: int, words: np.ndarray, counts: np.ndarray,
                    alive: np.ndarray | None = None, device="cpu") -> DBG:
    """Port DBG with the JAX DBG's node table (live rows: keys[:n],
    counts[:n], alive[:n]); node ids are equal on both sides."""
    n = len(words)
    dbg = DBG(k, keys_from_words(words, device),
              torch.from_numpy(np.asarray(counts, np.int64)).to(device), n)
    if alive is not None:
        dbg.alive = torch.from_numpy(np.asarray(alive[:n], bool)).to(device)
    return dbg


def contig_index_from_arrays(key_length: int, key_table: np.ndarray,
                             key_pos: np.ndarray, pool: np.ndarray,
                             starts: np.ndarray, lengths: np.ndarray,
                             table_len: int, device="cpu") -> ContigIndex:
    """Port ContigIndex from a JAX ContigIndex's numpy arrays (key_table
    (cap, W) u32 words with SENTINEL padding, key_pos, pool, starts,
    lengths, table_len), capacities and pad values as they are."""
    return ContigIndex.from_arrays(key_length, keys_from_words(key_table),
                                   key_pos, pool, starts, lengths, table_len,
                                   device)
