"""Build, bind and launch the port's CUDA kernels.

Each source under ``csrc/`` has a plain C interface. At first use every
source is compiled with its own ``nvcc`` for ``sm_90a``, all at once, into
``build/lib<source>_<hash>.so`` inside this package, and loaded with ctypes
(no PyTorch headers, so the build takes seconds). Pointers come from
``tensor.data_ptr()``, the stream from ``torch.cuda.current_stream()``. A
failed build or a refused launch raises ``KernelError``; nothing falls back
to the plain versions. ``NVCC_FLAGS`` stays free of ``--use_fast_math``:
the kernels' float decisions must round like the JAX package's.

``LAUNCHES`` counts the launches of each kernel; callers may reset it.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time
from types import SimpleNamespace

import torch

from .utils.errors import PlatanusError

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

LAUNCHES = {"edit_distance": 0, "kmer_extract": 0, "ungap_align": 0}
BUILD_INFO: dict = {}

_vp, _ci, _cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: name -> (restype, argtypes)
_SIGNATURES = {
    "platanus_edit_distance": (_ci, [_vp, _vp, _vp, _vp, _ci, _ci, _ci, _ci,
                                     _vp, _vp, _vp]),
    "platanus_edit_distance_uses_smem": (_ci, [_ci]),
    "platanus_kmer_extract": (_ci, [_vp, _vp, _vp, _ci, _ci, _ci, _ci, _ci,
                                    _ci, _vp, _vp, _vp]),
    "platanus_ungap_align": (_ci, [_vp, _vp, _ci, _ci, _vp, _ci, _vp, _vp,
                                   _vp, _vp, _vp, _vp, _ci, _cf, _vp, _vp,
                                   _vp, _vp, _vp, _vp]),
}

_lib = None


class KernelError(PlatanusError):
    """A CUDA kernel failed to build or to launch."""

    exit_id = 1


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if not found:
        raise KernelError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _target(src: str) -> str:
    digest = hashlib.sha256()
    with open(src, "rb") as f:
        digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    name = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def library() -> SimpleNamespace:
    """The kernels' C entry points, built from csrc/ on first use."""
    global _lib
    if _lib is not None:
        return _lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    todo = [(src, _target(src)) for src in _sources()]
    procs = []
    for src, so in todo:
        if not os.path.exists(so):
            tmp = f"{so}.{os.getpid()}.tmp"
            procs.append((src, so, tmp, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, so, tmp, proc in procs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"{os.path.basename(src)} ({proc.returncode}):\n{out}")
        else:
            os.replace(tmp, so)
    if failed:
        raise KernelError("nvcc failed: " + "\n".join(failed))
    BUILD_INFO.update(paths=[so for _s, so in todo],
                      seconds=time.perf_counter() - t0,
                      compiled=bool(procs), log="\n".join(logs))
    fns = {}
    for _src, so in todo:
        cdll = ctypes.CDLL(so)
        for name, (res, args) in _SIGNATURES.items():
            fn = getattr(cdll, name, None)
            if fn is not None:
                fn.restype, fn.argtypes = res, args
                fns[name] = fn
    missing = sorted(set(_SIGNATURES) - set(fns))
    if missing:
        raise KernelError(f"kernel library lacks {missing}")
    _lib = SimpleNamespace(**fns)
    return _lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise KernelError(f"{name} launch failed: cudaError {rc}")


def edit_distance(q: torch.Tensor, t: torch.Tensor, qlens: torch.Tensor,
                  tlens: torch.Tensor, bw: int, out: torch.Tensor) -> None:
    """Launch csrc/edit_distance.cu on CUDA tensors the caller checked."""
    lib = library()
    B, Lq = q.shape
    Lt = t.shape[1]
    scratch = None
    if not lib.platanus_edit_distance_uses_smem(bw):
        scratch = torch.empty(B * 3 * (bw + 3), dtype=torch.int32,
                              device=q.device)
    with torch.cuda.device(q.device):
        rc = lib.platanus_edit_distance(
            q.data_ptr(), t.data_ptr(), qlens.data_ptr(), tlens.data_ptr(),
            B, Lq, Lt, bw, out.data_ptr(),
            scratch.data_ptr() if scratch is not None else None, _stream(q))
    _check(rc, "edit_distance")
    LAUNCHES["edit_distance"] += 1


def kmer_extract(words: torch.Tensor, nmask: torch.Tensor | None,
                 lengths: torch.Tensor | None, k: int, P: int,
                 forward_only: bool, out: torch.Tensor,
                 n_valid: torch.Tensor) -> None:
    """Launch csrc/kmer_extract.cu on CUDA tensors the caller checked."""
    lib = library()
    R, Lw = words.shape
    W = -(-2 * k // 32)
    with torch.cuda.device(words.device):
        rc = lib.platanus_kmer_extract(
            words.data_ptr(), nmask.data_ptr() if nmask is not None else None,
            lengths.data_ptr() if lengths is not None else None,
            R, Lw, P, k, W, int(forward_only), out.data_ptr(),
            n_valid.data_ptr(), _stream(words))
    _check(rc, "kmer_extract")
    LAUNCHES["kmer_extract"] += 1


def ungap_align(codes: torch.Tensor, lengths: torch.Tensor,
                pool: torch.Tensor, starts: torch.Tensor, ok: torch.Tensor,
                is_fwd: torch.Tensor, cid: torch.Tensor, ro: torch.Tensor,
                clen: torch.Tensor, min_identity: float,
                out: tuple[torch.Tensor, ...]) -> None:
    """Launch csrc/ungap_align.cu on CUDA tensors the caller checked.
    out = (id, ro, identity, mis, span), each (R,). The kernel refuses
    S*H above what one read's entry arrays fit in a block's 227 KB of
    shared memory (8301 slots; polish at seed 32 and H 16 uses 80 for
    100 bp reads)."""
    lib = library()
    R, L = codes.shape
    SH = ok.shape[1] * ok.shape[2]
    with torch.cuda.device(codes.device):
        rc = lib.platanus_ungap_align(
            codes.data_ptr(), lengths.data_ptr(), R, L, pool.data_ptr(),
            pool.shape[0], starts.data_ptr(), ok.data_ptr(),
            is_fwd.data_ptr(), cid.data_ptr(), ro.data_ptr(), clen.data_ptr(),
            SH, float(min_identity), *(t.data_ptr() for t in out),
            _stream(codes))
    _check(rc, "ungap_align")
    LAUNCHES["ungap_align"] += 1
