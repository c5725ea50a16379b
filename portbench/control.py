"""The control of `correct`: a cell's runs with one of the configuration's
guarantees broken, on several seeds in one process, each judged as a
benchmark run is. The benchmark's own runs never run it.

    python3 portbench/control.py --workload <name> --control <name> --seeds 1 2 3 --seconds <s>

With `--control none` the same loop reads the sound program's numbers:
the lower readings of the limits, a dozen seeds in one process.

Controls (`CONTROLS`):
- hashed_count: the occurrence distribution that `assemble` writes comes
  from the reference itself, put in the program's place, with every
  canonical 32-mer cut to a 32-bit hash first: counting one precision
  below the exact keys the configuration states. frq_rows_off must fail.
- no_error_removal: `clean.delete_erroneous_iterative` leaves the graph
  as it is: the guarantee that erroneous unitigs are deleted before the
  contigs are written is broken. It reads mismatch_per_10kbp and
  size_gap_pct at their upper end.
- bf16_unitig_sums: the per-unitig coverage sums (`dbg.unitig_count_sums`,
  K7 on the card, in the graph's labeling and in cleaning's chain pull)
  come from the reference's own scatter-add, put in the program's place
  and run in bfloat16, the precision below the float32 the configuration
  states. cov_gap_pct must fail.
Each seed prints one JSON line: its `correct` and its numbers.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402


def hashed_count(inputs, device: str, k: int = 32):
    from portbench import reference as ref
    dist = ref.kmer_table(inputs.reads, k, device, hash_bits=32)[0]

    def make(orig):
        return lambda path, hist: orig(path, dist)
    return harness.patched("platanus_b_tpu_torch.ops.count:write_occurrence_tsv",
                           make)


def no_error_removal(inputs, device: str):
    return harness.patched(
        "platanus_b_tpu_torch.models.clean:delete_erroneous_iterative",
        lambda orig: (lambda *a, **kw: 0))


def bf16_sums(uid, counts, num_u: int, with_ulen: bool = False):
    """Per-unitig sums of node counts by a bfloat16 scatter-add (a node
    with no unitig adds into a dropped slot), with the int64 node count
    of each unitig where `with_ulen`."""
    import torch
    slot = torch.where(uid >= 0, uid, num_u)
    s = torch.zeros(num_u + 1, dtype=torch.bfloat16, device=uid.device)
    csum = s.index_add_(0, slot, counts.to(torch.bfloat16))[:num_u].float()
    if not with_ulen:
        return csum
    n = torch.zeros(num_u + 1, dtype=torch.int64, device=uid.device)
    return csum, n.index_add_(0, slot, torch.ones_like(slot))[:num_u]


@contextlib.contextmanager
def bf16_unitig_sums(inputs, device: str):
    with contextlib.ExitStack() as stack:
        for mod in ("dbg", "clean"):
            stack.enter_context(harness.patched(
                f"platanus_b_tpu_torch.models.{mod}:unitig_count_sums",
                lambda orig: bf16_sums))
        yield


CONTROLS = {"hashed_count": hashed_count, "no_error_removal": no_error_removal,
            "bf16_unitig_sums": bf16_unitig_sums}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--control", required=True,
                    choices=sorted(CONTROLS) + ["none"])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    import torch

    c = harness.cell(harness.benchmark(ROOT), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        print(f"{args.workload} needs {c.chips} CUDA card(s)", file=sys.stderr)
        return 2
    plant = CONTROLS.get(args.control)
    for seed in args.seeds:
        work = tempfile.mkdtemp(prefix="portbench-")
        try:
            r = harness.run_cell(c, seed, args.seconds, False, "cuda", work,
                                 time.perf_counter(),
                                 plant=plant and (lambda inputs:
                                                  plant(inputs, "cuda")))
        finally:
            shutil.rmtree(work, ignore_errors=True)
        print(json.dumps({"control": args.control, "workload": c.name,
                          "seed": seed, "correct": r["correct"],
                          "attempted": r["attempted"], "checks": r["checks"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
