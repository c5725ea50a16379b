"""control.py with the repeat cell's control, repeats_dropped: every
record at more than twice the median coverage is left out of the contig
file, so the planted copies' k-mers go missing and
repeat_kmers_absent_pct must fail. The benchmark's own runs never run it.

    python3 portbench/repeat_control.py --workload asm-4600k-rep-40x --control repeats_dropped --seeds 1 2 3 --seconds 0

Every control of control.py runs here as well.
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import control, harness  # noqa: E402


def drop_repeats(orig):
    def contigs_of(dbg, ratio):
        contigs, covs = orig(dbg, ratio)
        keep = np.asarray(covs) <= 2 * np.median(covs)
        return ([s for s, ok in zip(contigs, keep) if ok],
                [v for v, ok in zip(covs, keep) if ok])
    return contigs_of


def repeats_dropped(inputs, device: str):
    return harness.patched(
        "platanus_b_tpu_torch.models.assemble_core:_contigs_of", drop_repeats)


def main(argv=None) -> int:
    control.CONTROLS = dict(control.CONTROLS, repeats_dropped=repeats_dropped)
    return control.main(argv)


if __name__ == "__main__":
    sys.exit(main())
