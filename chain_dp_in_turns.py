#!/usr/bin/env python3
"""An earlier chain_dp.cu against the current one, in turns, on one CUDA card.

    git show <commit>:platanus_b_tpu_torch/csrc/chain_dp.cu \\
        > platanus_b_tpu_torch/build/chain_dp_old.cu
    python3 chain_dp_in_turns.py platanus_b_tpu_torch/build/chain_dp_old.cu

Builds the given source and platanus_b_tpu_torch/csrc/chain_dp.cu with the
port's nvcc flags into platanus_b_tpu_torch/build/in_turns/, runs both on
the inputs of chip_smoke.CHAIN_SHAPES (simulate.chain_dp_inputs), requires
their f (as uint32) and prev to be equal, and times them with
chip_smoke.cuda_ms in the order old, new, new, old. Prints one JSON line a
shape (each source's ms and ns a step, and the SM clock nvidia-smi reads
while the new one runs), then the card's name and power limit. It stays
out of chip_smoke.py, which builds only the checkout's own sources. Exits
non-zero without a card, on a failed build or on unequal results.
"""

from __future__ import annotations

import json
import os
import sys

import chip_smoke as cs
import in_turns as it


def launch(fn, q, t, n, H, max_gap, kk, table):
    import torch
    B, cap = q.shape
    f = torch.empty((B, cap), dtype=torch.float32, device=q.device)
    prev = torch.empty((B, cap), dtype=torch.int32, device=q.device)
    rc = fn(q.data_ptr(), t.data_ptr(), n.data_ptr(), B, cap, H, max_gap, kk,
            table.data_ptr(), f.data_ptr(), prev.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    cs.check(rc == 0, f"chain_dp launch failed: cudaError {rc}")
    return f, prev


def main() -> int:
    it.require_card("chain_dp_in_turns.py OLD_chain_dp.cu",
                    len(sys.argv) == 2)
    import torch

    from platanus_b_tpu_torch.ops import chain
    from platanus_b_tpu_torch.simulate import chain_dp_inputs
    libs = it.build_all([
        ("chain_dp_old", os.path.abspath(sys.argv[1]), []),
        ("chain_dp_new", os.path.join(it.CSRC, "chain_dp.cu"), [])])
    fns = {k: it.bind(libs[f"chain_dp_{k}"], "platanus_chain_dp")
           for k in ("old", "new")}
    dev = torch.device("cuda")
    for name, cap, B, H, max_gap, kk in cs.CHAIN_SHAPES:
        qs, ts, ns = chain_dp_inputs(cap, B, cap, max_gap, edges=False)
        q, t, n = (torch.from_numpy(x).to(dev) for x in (qs, ts, ns))
        table = chain.gap_cost_table(max_gap, dev)
        runs = {k: (lambda fn=fn: launch(fn, q, t, n, H, max_gap, kk, table))
                for k, fn in fns.items()}
        (of, op), (nf, np_) = runs["old"](), runs["new"]()
        cs.check(torch.equal(of.view(torch.int32), nf.view(torch.int32))
                 and torch.equal(op, np_), f"{name}: old != new")
        ms = it.in_turns(runs, reps=20 if cap <= 8192 else 5)
        steps = int(ns.max()) - 1
        print(json.dumps({
            "set": name, "groups": B, "longest_group_steps": steps, "ms": ms,
            "ns_per_step": {k: [1e6 * x / steps for x in v]
                            for k, v in ms.items()},
            "sm_clock_mhz": cs.sm_clock_mhz(runs["new"], min(ms["new"]))}),
            flush=True)
    print(cs.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
