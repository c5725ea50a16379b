"""The benchmark's command: one run of one cell on the card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in setup_s from the process's start): imports, the
kernel library (built into platanus_b_tpu_torch/build/ on a checkout's
first run, loaded from there afterwards), the reads made from the seed
and written as FASTA under $TMPDIR, and one warm-up job. Then `assemble`
jobs through the port's CLI, one after another, for --seconds; then one
more job on a dataset drawn from the seed, and the check of its files
and of the window's first job's against the plain reference. The last line of standard output is
the result as one JSON object; the numbers compared, each beside its
limit, are the last lines of standard error.

It exits non-zero and prints no result where no CUDA card (or fewer than
the cell asks for) is present, and where jax, jaxlib, flax or the JAX
package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time


def process_start() -> float:
    """This process's start on the perf_counter clock (Linux /proc), or
    now where that cannot be read."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return now - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return now


T0 = process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness
    c = harness.cell(harness.benchmark(ROOT), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        print(f"{args.workload} needs {c.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    work = tempfile.mkdtemp(prefix="portbench-")
    try:
        result = harness.run_cell(c, args.seed, args.seconds, bool(args.trace),
                                  "cuda", work, T0)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, chk in result["checks"].items():
        print(f"check {name} {chk['value']} limit {chk['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
