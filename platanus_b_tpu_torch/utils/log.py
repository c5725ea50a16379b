"""Stage logger: banners, counters, per-stage wall clock, memory report.

Counterpart of platanus_b_tpu/utils/log.py. A stage that ran CUDA work
synchronises the card before its clock stops, so stage times include the
device work queued inside the stage, not only its launch.
"""

from __future__ import annotations

import contextlib
import sys
import time

import torch


class StageLogger:
    """Stage-scoped stderr logger with wall-clock + counter telemetry."""

    def __init__(self, out=None):
        self.out = out if out is not None else sys.stderr
        self.timings: dict[str, float] = {}
        self.counters: dict[str, int | float] = {}
        self.started = time.perf_counter()

    def info(self, msg: str) -> None:
        print(msg, file=self.out, flush=True)

    def counter(self, name: str, value) -> None:
        """Named counter, echoed like the reference's stderr counters."""
        self.counters[name] = value
        print(f"{name} = {value}", file=self.out, flush=True)

    def reset(self) -> None:
        self.timings.clear()
        self.counters.clear()

    @contextlib.contextmanager
    def stage(self, name: str):
        self.info(f"{name}...")
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            self.timings[name] = self.timings.get(name, 0.0) + dt
            self.info(f"{name} done ({dt:.2f} s)")

    def report_memory(self) -> None:
        """Peak RSS in GB, like main.cpp:129-146 VmPeak/VmHWM."""
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith(("VmPeak", "VmHWM")):
                        parts = line.split()
                        gb = int(parts[1]) / (1024 * 1024)
                        self.info(f"#### PROCESS INFORMATION ####\n{parts[0][:-1]}: {gb:.3f} GByte")
        except OSError:
            pass

    def report_device_memory(self) -> None:
        """Peak device memory allocated by PyTorch on each visible card."""
        if not torch.cuda.is_initialized():
            return
        for d in range(torch.cuda.device_count()):
            peak = torch.cuda.max_memory_allocated(d) / (1 << 30)
            used = torch.cuda.memory_allocated(d) / (1 << 30)
            self.info(f"#### DEVICE cuda:{d} ({torch.cuda.get_device_name(d)}) "
                      f"#### in_use: {used:.3f} GiB, peak: {peak:.3f} GiB")


LOG = StageLogger()
