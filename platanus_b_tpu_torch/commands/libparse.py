"""Numbered paired-library CLI syntax: -IP{n}/-ip{n}/-OP{n}/-op{n}
(counterpart of platanus_b_tpu/commands/libparse.py; only the PairLibrary
import differs).

Reproduces BaseCommand's pair-file option handling (baseCommand.h:52-68,
baseCommand.cpp divideArgvInt): the numeric suffix is the library ID,
-IP/-OP take fwd/rev file pairs, -ip/-op take interleaved files, and
-op/-OP (outward mate pairs) are reverse-complemented at load time into
innie orientation (seqlib.cpp:398-401).

argparse cannot express dynamic flag names, so callers pre-extract these
tokens from argv with extract_library_args() before argparse runs.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field

import numpy as np

from ..models.seqlib import PairLibrary
from ..utils.errors import ArgError, IOError_

PAIR_FLAG_RE = re.compile(r"^-(IP|ip|OP|op)(\d+)$")


@dataclass
class LibrarySpec:
    lib_id: int
    entries: list = field(default_factory=list)  # (type, [files...])


def extract_library_args(argv: list[str]) -> tuple[list[str], list[LibrarySpec]]:
    """Split argv into (argparse-able remainder, ordered library specs)."""
    rest: list[str] = []
    by_id: dict[int, LibrarySpec] = {}
    i = 0
    while i < len(argv):
        m = PAIR_FLAG_RE.match(argv[i])
        if not m:
            rest.append(argv[i])
            i += 1
            continue
        kind, lid = m.group(1), int(m.group(2))
        files = []
        i += 1
        while i < len(argv) and not argv[i].startswith("-"):
            files.append(argv[i])
            i += 1
        if not files:
            raise ArgError(f"-{kind}{lid}: no files given")
        if kind in ("IP", "OP") and len(files) % 2 != 0:
            raise ArgError(f"-{kind}{lid}: needs fwd/rev file pairs")
        spec = by_id.setdefault(lid, LibrarySpec(lib_id=lid))
        spec.entries.append((kind, files))
    return rest, [by_id[k] for k in sorted(by_id)]


def _load_packed(path: str) -> tuple[np.ndarray, np.ndarray]:
    """One file as a padded (rows, lengths) matrix via the native decoder
    + row packer (no per-read Python objects; library ingest was ~20% of
    gap_close wall at 240k-pair scale through the list-based path)."""
    if not os.path.exists(path):
        raise IOError_(f"cannot open file: {path}")
    from .. import native
    from ..io.fasta import load_codes
    codes, starts = load_codes(path)
    lens = np.diff(starts).astype(np.int32)
    lmax = int(lens.max()) if len(lens) else 0
    mat = native.pack_rows(np.ascontiguousarray(codes),
                           np.ascontiguousarray(starts, np.int64) if
                           starts.dtype != np.int64 else starts, lmax)
    return mat, lens


def _rc_rows(mat: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Per-row reverse-complement of a padded code matrix."""
    lmax = mat.shape[1]
    if lmax == 0:
        return mat
    idx = lens[:, None].astype(np.int64) - 1 - np.arange(lmax)[None, :]
    out = mat[np.arange(len(mat))[:, None], np.clip(idx, 0, lmax - 1)]
    out = np.where(idx >= 0, out, np.uint8(4))
    m = out < 4
    out[m] = 3 - out[m]
    return out.astype(np.uint8)


def load_pair_library(spec: LibrarySpec) -> PairLibrary:
    """Load all entries of one library ID into a single PairLibrary."""
    fparts: list[tuple[np.ndarray, np.ndarray]] = []
    rparts: list[tuple[np.ndarray, np.ndarray]] = []
    for kind, files in spec.entries:
        mate = kind in ("op", "OP")
        if kind in ("ip", "op"):
            for path in files:
                mat, lens = _load_packed(path)
                if len(lens) % 2 != 0:
                    raise ArgError(f"{path}: the number of read is odd in file.")
                fm, fl = mat[0::2], lens[0::2]
                rm, rl = mat[1::2], lens[1::2]
                if mate:
                    fm, rm = _rc_rows(fm, fl), _rc_rows(rm, rl)
                fparts.append((fm, fl))
                rparts.append((rm, rl))
        else:
            for f1, f2 in zip(files[0::2], files[1::2]):
                m1, l1 = _load_packed(f1)
                m2, l2 = _load_packed(f2)
                if len(l1) != len(l2):
                    raise ArgError(f"{f1}/{f2}: unequal pair counts")
                if mate:
                    m1, m2 = _rc_rows(m1, l1), _rc_rows(m2, l2)
                fparts.append((m1, l1))
                rparts.append((m2, l2))

    def cat(parts):
        if not parts:
            return np.zeros((0, 0), np.uint8), np.zeros(0, np.int32)
        w = max(p[0].shape[1] for p in parts)
        mats = [np.pad(p[0], ((0, 0), (0, w - p[0].shape[1])),
                       constant_values=4) if p[0].shape[1] < w else p[0]
                for p in parts]
        return np.vstack(mats), np.concatenate([p[1] for p in parts])

    fm, fl = cat(fparts)
    rm, rl = cat(rparts)
    return PairLibrary(fm, fl, rm, rl)


def load_libraries(specs: list[LibrarySpec]) -> list[PairLibrary]:
    return [load_pair_library(s) for s in specs]
