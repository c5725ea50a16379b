"""FASTA/FASTQ IO and the contig-header metadata codec.

The reference's contig FASTA headers are the inter-stage ABI:
``>seqN_lenL_covC_readR_maxKK`` written by printContig (common.h:313-345)
and parsed back by findCoverageFromHeader (common.h:659-674) /
getReadLength (common.h:686-704). This module reproduces those semantics
exactly: cov is ``uint16(cov * ratio + 0.5)``, sequences wrap at
OUTPUT_LINE_LENGTH=80 (common.cpp:30).

Compressed input is handled with Python's gzip/bz2 modules instead of
``popen("gzip -cd")`` subprocesses (reference: common.cpp:120-144).

Port copy of platanus_b_tpu/io/fasta.py: host ingest, byte for byte the
reference's behaviour; only the decoder's module name differs.
"""

from __future__ import annotations

import bz2
import gzip
import io
import lzma
import os
from typing import Iterable, Iterator

import numpy as np

from ..utils.constants import OUTPUT_LINE_LENGTH
from ..utils.errors import FormatError

# base <-> code tables (common.h:256-257: Char2Bin / Bin2Char)
_CHAR2BIN = np.full(256, 4, dtype=np.uint8)
for _c, _v in (("A", 0), ("C", 1), ("G", 2), ("T", 3),
               ("a", 0), ("c", 1), ("g", 2), ("t", 3)):
    _CHAR2BIN[ord(_c)] = _v
_BIN2CHAR = np.frombuffer(b"ACGTN", dtype=np.uint8)


def open_maybe_compressed(path: str, mode: str = "rt"):
    """Open plain / gzip / bzip2 / xz by magic-byte sniffing.

    Replaces the reference's ``file -bL`` subprocess format check
    (common.cpp:88-117).
    """
    with open(path, "rb") as f:
        magic = f.read(6)
    if magic[:2] == b"\x1f\x8b":
        return gzip.open(path, mode)
    if magic[:3] == b"BZh":
        return bz2.open(path, mode)
    if magic[:6] == b"\xfd7zXZ\x00":
        return lzma.open(path, mode)
    return open(path, mode)


def sniff_format(path: str) -> str:
    """Return 'fasta' or 'fastq' from the first non-blank character."""
    with open_maybe_compressed(path) as f:
        for line in f:
            if line.strip():
                c = line[0]
                if c == ">":
                    return "fasta"
                if c == "@":
                    return "fastq"
                raise FormatError(f"{path}: not FASTA/FASTQ (first char {c!r})")
    raise FormatError(f"{path}: empty input")


def iter_fasta(path: str) -> Iterator[tuple[str, str]]:
    """Yield (name, sequence) records from a (possibly compressed) FASTA."""
    name = None
    chunks: list[str] = []
    with open_maybe_compressed(path) as f:
        for line in f:
            line = line.rstrip("\n\r")
            if not line:
                continue
            if line[0] == ">":
                if name is not None:
                    yield name, "".join(chunks)
                name = line[1:].split()[0] if len(line) > 1 else ""
                chunks = []
            else:
                chunks.append(line)
        if name is not None:
            yield name, "".join(chunks)


def iter_fastq(path: str) -> Iterator[tuple[str, str]]:
    """Yield (name, sequence) records from a (possibly compressed) FASTQ."""
    with open_maybe_compressed(path) as f:
        while True:
            h = f.readline()
            if not h:
                return
            h = h.rstrip("\n\r")
            if not h:
                continue
            if h[0] != "@":
                raise FormatError(f"{path}: bad FASTQ header {h!r}")
            seq = f.readline().rstrip("\n\r")
            plus = f.readline()
            qual = f.readline()
            if not qual:
                raise FormatError(f"{path}: truncated FASTQ record")
            yield h[1:].split()[0] if len(h) > 1 else "", seq


def iter_reads(path: str) -> Iterator[tuple[str, str]]:
    """Yield records, auto-detecting FASTA vs FASTQ (seqlib.cpp loaders)."""
    if sniff_format(path) == "fasta":
        yield from iter_fasta(path)
    else:
        yield from iter_fastq(path)


def is_compressed(path: str) -> bool:
    with open(path, "rb") as f:
        magic = f.read(6)
    return (magic[:2] == b"\x1f\x8b" or magic[:3] == b"BZh"
            or magic[:6] == b"\xfd7zXZ\x00")


def _record_start_after(data: bytes, pos: int, fmt: str) -> int:
    """Offset of the first record start at offset >= pos (len(data) if none).

    A record starts at offset 0 or right after a newline, with '>' (FASTA)
    or '@' (FASTQ). FASTQ '@' is ambiguous (quality lines may start with
    it), so a candidate is validated by the '+' separator two lines on.
    """
    marker = b">" if fmt == "fasta" else b"@"
    if pos <= 0:
        if data[:1] == marker and (fmt == "fasta" or _fastq_start_ok(data, 0)):
            return 0
        pos = 1
    i = pos - 1
    while True:
        j = data.find(b"\n" + marker, i)
        if j == -1:
            return len(data)
        cand = j + 1
        if fmt == "fasta" or _fastq_start_ok(data, cand):
            return cand
        i = cand


def _fastq_start_ok(data: bytes, cand: int) -> bool:
    e1 = data.find(b"\n", cand)
    if e1 == -1:
        return False
    e2 = data.find(b"\n", e1 + 1)
    return e2 != -1 and data[e2 + 1: e2 + 2] == b"+"


def _read_range_bytes(path: str, fmt: str, byte_start: int,
                      byte_end: int) -> bytes:
    """The bytes of all records STARTING in [byte_start, byte_end).

    The record straddling byte_end is read to completion; a record
    straddling byte_start belongs to the previous range's owner. Ranges
    produced by multihost.host_read_plan therefore partition the records.
    """
    size = os.path.getsize(path)
    byte_end = size if byte_end < 0 else min(byte_end, size)
    with open(path, "rb") as f:
        lead = 1 if byte_start > 0 else 0
        f.seek(byte_start - lead)
        buf = f.read(byte_end - byte_start + lead)
        end_off = len(buf)
        # extend past byte_end to the next record start (or EOF)
        while True:
            nxt = _record_start_after(buf, end_off, fmt)
            if nxt < len(buf):
                buf = buf[:nxt]
                break
            chunk = f.read(1 << 20)
            if not chunk:
                break
            buf += chunk
    first = _record_start_after(buf, lead, fmt) if lead else \
        _record_start_after(buf, 0, fmt)
    return buf[first:]


def _codes_from_bytes(data: bytes, fmt: str) -> tuple[np.ndarray, np.ndarray]:
    seqs: list[np.ndarray] = []
    if fmt == "fasta":
        for block in data.split(b"\n>"):
            if not block:
                continue
            if block[:1] == b">":
                block = block[1:]
            nl = block.find(b"\n")
            if nl == -1:
                continue
            seq = block[nl + 1:].replace(b"\n", b"").replace(b"\r", b"")
            seqs.append(_CHAR2BIN[np.frombuffer(seq, dtype=np.uint8)])
    else:
        lines = data.split(b"\n")
        i = 0
        while i + 1 < len(lines):
            if not lines[i].startswith(b"@"):
                i += 1
                continue
            seq = lines[i + 1].rstrip(b"\r")
            seqs.append(_CHAR2BIN[np.frombuffer(seq, dtype=np.uint8)])
            i += 4
    starts = np.zeros(len(seqs) + 1, dtype=np.int64)
    if seqs:
        np.cumsum([len(s) for s in seqs], out=starts[1:])
        codes = np.concatenate(seqs)
    else:
        codes = np.zeros(0, np.uint8)
    return codes, starts


def load_codes(path: str, byte_start: int = 0,
               byte_end: int = -1) -> tuple[np.ndarray, np.ndarray]:
    """All reads of a file as (codes (uint8 concat), starts (int64, n+1)).

    Fast path: the native C++ decoder (the port's native module) over the
    (decompressed) file image; falls back to the Python parsers.

    (byte_start, byte_end) restricts to records starting in that byte
    range of the UNCOMPRESSED file — the multi-host ingest partition unit
    (multihost.host_read_plan); compressed files cannot be range-split.
    """
    fmt = sniff_format(path)
    from .. import native
    ranged = byte_start > 0 or byte_end >= 0
    if ranged:
        if is_compressed(path):
            raise FormatError(
                f"{path}: byte-range reads require an uncompressed file")
        data = _read_range_bytes(path, fmt, byte_start, byte_end)
        if native.available():
            out = native.decode_reads(data, fmt)
            if out is not None:
                return out
        return _codes_from_bytes(data, fmt)
    if native.available():
        with open_maybe_compressed(path, "rb") as f:
            data = f.read()
        out = native.decode_reads(data, fmt)
        if out is not None:
            return out
    seqs = [seq_to_codes(s) for _n, s in iter_reads(path)]
    starts = np.zeros(len(seqs) + 1, dtype=np.int64)
    if seqs:
        np.cumsum([len(s) for s in seqs], out=starts[1:])
        codes = np.concatenate(seqs)
    else:
        codes = np.zeros(0, np.uint8)
    return codes, starts


def seq_to_codes(seq: str) -> np.ndarray:
    """ACGT(N) string -> uint8 codes 0..4 (common.h:256 Char2Bin)."""
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return _CHAR2BIN[raw]


def codes_to_seq(codes: np.ndarray) -> str:
    """uint8 codes 0..4 -> ACGTN string (common.h:257 Bin2Char)."""
    return _BIN2CHAR[np.minimum(codes, 4)].tobytes().decode("ascii")


# ---------------------------------------------------------------------------
# contig-header metadata codec (the inter-stage ABI)
# ---------------------------------------------------------------------------

def format_contig_header(prefix: str, index1: int, length: int, cov: float,
                         coverage_ratio: float = 1.0,
                         read_length: float | None = None,
                         max_k: int | None = None) -> str:
    """``>prefixN_lenL_covC[_readR][_maxKK]`` per printContig (common.h:334).

    cov is clamped to uint16 after ``cov * ratio + 0.5`` rounding, matching
    ``static_cast<unsigned short>(cov * coverageRatio + 0.5)``.
    """
    c = int(cov * coverage_ratio + 0.5) & 0xFFFF
    s = f"{prefix}{index1}_len{length}_cov{c}"
    if read_length is not None:
        r = int(read_length) if float(read_length) == int(read_length) else read_length
        s += f"_read{r}"
    if max_k is not None:
        s += f"_maxK{max_k}"
    return s


def find_value_from_header(name: str, key: str, default: int = 1) -> int:
    """Digits following the first occurrence of `key` in the header.

    Reproduces findCoverageFromHeader (common.h:659-674): returns `default`
    (=1 for cov) when the key is absent.
    """
    pos = name.find(key)
    if pos < 0:
        return default
    pos += len(key)
    val = 0
    seen = False
    while pos < len(name) and name[pos].isdigit():
        val = val * 10 + int(name[pos])
        pos += 1
        seen = True
    return val if seen else default


def parse_cov(name: str) -> int:
    return find_value_from_header(name, "cov", 1)


def parse_read_length(name: str) -> int:
    """getReadLengthFromFastaHeader (common.h:686): '<=1' falls back to 100."""
    v = find_value_from_header(name, "read", 1)
    return v if v > 1 else 100


def parse_max_k(name: str) -> int:
    v = find_value_from_header(name, "maxK", 1)
    return v if v > 1 else 100


def write_fasta(path: str, records: Iterable[tuple[str, str]],
                line_length: int = OUTPUT_LINE_LENGTH,
                append: bool = False) -> int:
    """Write (name, seq) records with 80-column wrapping (common.h:336-343)."""
    n = 0
    with open(path, "a" if append else "w") as out:
        for name, seq in records:
            out.write(f">{name}\n")
            for i in range(0, len(seq), line_length):
                out.write(seq[i:i + line_length])
                out.write("\n")
            if len(seq) == 0:
                out.write("\n")
            n += 1
    return n


def write_contigs(path: str, seqs: list[np.ndarray] | list[str],
                  covs: Iterable[float], coverage_ratio: float,
                  read_length: float, max_k: int,
                  prefix: str = "seq", append: bool = False) -> int:
    """printContig equivalent (common.h:313-345): skips cov==UINT16_MAX
    (deleted) sequences and numbers survivors 1..N."""
    def gen():
        i = 0
        for seq, cov in zip(seqs, covs):
            if int(cov) == 0xFFFF:
                continue
            i += 1
            s = seq if isinstance(seq, str) else codes_to_seq(seq)
            yield format_contig_header(prefix, i, len(s), cov, coverage_ratio,
                                       read_length, max_k), s
    return write_fasta(path, gen(), append=append)


def bulk_fasta_codes(path: str):
    """Whole-file vectorized FASTA decode: (codes (R, Lmax) uint8 matrix
    padded with 4, lengths (R,) int32), or None when the file is
    compressed / FASTQ (callers fall back to the record iterator).

    One numpy pass over the raw bytes classifies lines, assigns every
    sequence character its record id, and scatters into the padded
    matrix — the per-read Python loop it replaces dominated library
    ingest at 100k+-read scale (seqlib.cpp's loaders are the
    counterpart, they stream into per-thread files)."""
    if is_compressed(path) or sniff_format(path) != "fasta":
        return None
    raw = np.frombuffer(open(path, "rb").read(), dtype=np.uint8)
    if len(raw) == 0:
        return np.zeros((0, 0), np.uint8), np.zeros(0, np.int32)
    nl = raw == 10
    # line id per character (exclusive cumsum of newline flags)
    line_of = np.zeros(len(raw), np.int64)
    np.cumsum(nl[:-1], out=line_of[1:])
    n_lines = int(line_of[-1]) + 1
    line_start_mask = np.ones(len(raw), bool)
    line_start_mask[1:] = nl[:-1]
    starts = np.flatnonzero(line_start_mask)
    is_hdr = np.zeros(n_lines, bool)
    is_hdr[line_of[starts]] = raw[starts] == ord(">")
    rec_of_line = np.cumsum(is_hdr) - 1
    keep = (~nl) & (~is_hdr[line_of]) & (raw != 13)
    if not is_hdr.any():
        raise FormatError(f"{path}: no FASTA records")
    flat = _CHAR2BIN[raw[keep]]
    rec_of_char = rec_of_line[line_of[keep]]
    n_rec = int(is_hdr.sum())
    lengths = np.bincount(rec_of_char, minlength=n_rec).astype(np.int32)
    lmax = int(lengths.max()) if n_rec else 0
    mat = np.full((n_rec, lmax), 4, np.uint8)
    rec_start = np.zeros(n_rec, np.int64)
    rec_start[1:] = np.cumsum(lengths.astype(np.int64))[:-1]
    col = np.arange(len(flat), dtype=np.int64) - rec_start[rec_of_char]
    mat[rec_of_char, col] = flat
    return mat, lengths
