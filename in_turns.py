"""What the *_in_turns.py scripts share: kernel sources built at once with
the port's nvcc flags, a C entry point bound by its signature in
platanus_b_tpu_torch/kernels.py, and runs timed in turns (in order, then
in reverse) with chip_smoke.cuda_ms. Needs a CUDA card; imports torch and
the port only inside the functions that use them."""

from __future__ import annotations

import ctypes
import json
import os
import subprocess

import chip_smoke as cs

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "platanus_b_tpu_torch", "build", "in_turns")
CSRC = os.path.join(REPO, "platanus_b_tpu_torch", "csrc")


def require_card(usage: str, argc_ok: bool) -> None:
    """Exit with `usage` on wrong arguments, or when there is no card; make
    OUT_DIR."""
    if not argc_ok:
        cs.fail(f"usage: {usage}")
    import torch
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: needs a CUDA card")
    os.makedirs(OUT_DIR, exist_ok=True)


def build_all(sources: list[tuple[str, str, list[str]]]) -> dict:
    """Each (name, source path, extra nvcc flags) built at once into
    OUT_DIR/lib<name>.so; prints the builds' ptxas summaries as one JSON
    line and returns {name: ctypes library}."""
    from platanus_b_tpu_torch import kernels
    procs = []
    for name, src, flags in sources:
        so = os.path.join(OUT_DIR, f"lib{name}.so")
        procs.append((name, so, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, *flags, "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs, ptxas = {}, {}
    for name, so, proc in procs:
        out, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"nvcc {name}: {out}")
        libs[name] = ctypes.CDLL(so)
        ptxas[name] = cs.ptxas_summary(out)
    print(json.dumps({"ptxas": ptxas}), flush=True)
    return libs


def bind(lib, symbol: str):
    """lib.<symbol> with its restype and argtypes from kernels._SIGNATURES."""
    from platanus_b_tpu_torch import kernels
    fn = getattr(lib, symbol)
    fn.restype, fn.argtypes = kernels._SIGNATURES[symbol]
    return fn


def patched(src: str, name: str, edits: dict[str, str]) -> str:
    """A copy of `src` under OUT_DIR as <name>.cu, each key of `edits`
    (which must occur exactly once) replaced by its value: a variant build
    of a kernel without build options in the shipped source."""
    with open(src) as f:
        text = f.read()
    for old, new in edits.items():
        cs.check(text.count(old) == 1,
                 f"{name}: {old!r} occurs {text.count(old)} times")
        text = text.replace(old, new)
    path = os.path.join(OUT_DIR, f"{name}.cu")
    with open(path, "w") as f:
        f.write(text)
    return path


def in_turns(runs: dict, reps: int = 20) -> dict[str, list[float]]:
    """{name: [ms, ms]}: each run timed with chip_smoke.cuda_ms in the
    order of `runs`, then in reverse."""
    ms: dict[str, list[float]] = {k: [] for k in runs}
    for k in list(runs) + list(reversed(runs)):
        ms[k].append(cs.cuda_ms(runs[k], reps=reps))
    return ms
