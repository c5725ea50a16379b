"""CLI entry point (counterpart of platanus_b_tpu/commands/main.py).

Usage: python -m platanus_b_tpu_torch <command> [options]

All 12 subcommands of platanus_b_tpu are in COMMANDS; an unknown one gets
argparse's usage message and exit code 2, as in the JAX package. Paired-library
flags (-IP1 r1 r2, -ip2 ..., -OP/-op) are taken out of argv before
argparse runs, as the JAX package does (main.py:79-86).
"""

from __future__ import annotations

import argparse
import sys

from .. import REFERENCE_VERSION, __version__
from ..utils.errors import PlatanusError
from ..utils.log import LOG

COMMANDS = ("assemble", "scaffold", "solve_dbg", "gap_close", "polish",
            "merge", "kmer_divide", "iterate", "divide", "consensus", "phase",
            "combine")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="platanus_b_tpu_torch",
        description=(f"platanus_b_tpu_torch v{__version__} — PyTorch/CUDA "
                     f"port of platanus_b_tpu (Platanus_B v{REFERENCE_VERSION} "
                     f"capabilities); commands: {', '.join(COMMANDS)}"))
    sub = parser.add_subparsers(dest="command", required=True)
    from . import (assemble_cmd, combine_cmd, gap_close_cmd, iterate_cmd,
                   kmer_divide_cmd, merge_cmd, orchestrators, polish_cmd,
                   scaffold_cmd, solve_dbg_cmd)
    assemble_cmd.add_parser(sub)
    scaffold_cmd.add_parser(sub)
    solve_dbg_cmd.add_parser(sub)
    gap_close_cmd.add_parser(sub)
    polish_cmd.add_parser(sub)
    merge_cmd.add_parser(sub)
    kmer_divide_cmd.add_parser(sub)
    iterate_cmd.add_parser(sub)
    orchestrators.add_parsers(sub)
    combine_cmd.add_parser(sub)
    return parser


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    # multi-process bring-up (torchrun's MASTER_ADDR & friends) runs before
    # any device use; logs whether multi-process mode is active
    from ..parallel import multihost as mh
    if mh.initialize():
        LOG.info(f"multi-host runtime: process {mh.process_index()} "
                 f"of {mh.process_count()}")
        try:
            return _run(argv)
        finally:
            import torch.distributed as dist
            dist.destroy_process_group()
    return _run(argv)


def _run(argv: list[str]) -> int:
    LOG.info(f"platanus_b_tpu_torch version {__version__} "
             f"(Platanus_B {REFERENCE_VERSION} capabilities)")
    LOG.info("Command: " + " ".join(argv))
    try:
        from .libparse import extract_library_args
        argv, libspecs = extract_library_args(argv)
        args = build_parser().parse_args(argv)
        args.libspecs = libspecs
        rc = args.func(args)
    except PlatanusError as e:
        LOG.info(f"ERROR({e.exit_id}): {e.message}")
        return e.exit_id
    except OSError as e:
        LOG.info(f"ERROR(2): {e}")
        return 2
    return rc or 0


if __name__ == "__main__":
    raise SystemExit(main())
