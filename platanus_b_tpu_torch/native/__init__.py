"""Native runtime components: build-on-first-use C++ IO via ctypes.

The shared library is compiled from io_native.cpp with g++ -O3 on first
import (cached in the package's build/ directory); everything degrades to
the pure-Python implementations when no compiler is available.

Port copy of platanus_b_tpu/native/__init__.py: the library is built
from this package's verbatim copy of io_native.cpp into the package's
build/ directory, which git ignores, so a run writes nothing beside the
sources. Each process compiles into a temporary file of its own and
renames it into place, so processes that start together on a fresh
checkout (the ranks of one torchrun) never load a half-written library.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "io_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build")
_LIB = os.path.join(BUILD_DIR,
                    f"_io_native_{sys.implementation.cache_tag}.so")

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        if (not os.path.exists(_LIB)
                or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{_LIB}.{os.getpid()}.tmp"
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC",
                 "-o", tmp, _SRC],
                check=True, capture_output=True)
            os.replace(tmp, _LIB)
        lib = ctypes.CDLL(_LIB)
        for fn in ("decode_fasta", "decode_fastq"):
            getattr(lib, fn).restype = ctypes.c_long
            getattr(lib, fn).argtypes = [
                ctypes.c_char_p, ctypes.c_long,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int64), ctypes.c_long]
        lib.pack_rows.restype = None
        lib.pack_rows.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_long, ctypes.POINTER(ctypes.c_uint8), ctypes.c_long]
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def decode_reads(data: bytes, fmt: str):
    """Decode a FASTA/FASTQ file image -> (codes (uint8), starts (int64)).

    Returns None when the native library is unavailable or parsing fails
    (caller falls back to Python).
    """
    lib = _load()
    if lib is None:
        return None
    n = len(data)
    if n == 0:
        return np.zeros(0, np.uint8), np.zeros(1, np.int64)
    max_records = max(data.count(b"\n") // (4 if fmt == "fastq" else 1) + 2,
                      16)
    codes = np.empty(n, dtype=np.uint8)
    starts = np.empty(max_records + 1, dtype=np.int64)
    fn = lib.decode_fastq if fmt == "fastq" else lib.decode_fasta
    count = fn(data, n,
               codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
               starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
               max_records)
    if count < 0:
        return None
    total = int(starts[count])
    return codes[:total].copy(), starts[: count + 1].copy()


def pack_rows(codes: np.ndarray, starts: np.ndarray, max_len: int
              ) -> np.ndarray:
    """Dense padded row matrix from (codes, starts) via the native packer."""
    lib = _load()
    count = len(starts) - 1
    out = np.empty((count, max_len), dtype=np.uint8)
    if lib is None:
        out.fill(4)
        for r in range(count):
            s, e = int(starts[r]), int(starts[r + 1])
            L = min(e - s, max_len)
            out[r, :L] = codes[s: s + L]
        return out
    lib.pack_rows(codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                  starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                  count,
                  out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                  max_len)
    return out
