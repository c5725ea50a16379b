"""Stage logger: banners, counters, per-stage wall clock, stage records,
memory report.

Counterpart of platanus_b_tpu/utils/log.py. A stage that ran CUDA work
synchronises the card before its clock stops, so stage times include the
device work queued inside the stage, not only its launch. Every stage
occurrence also leaves a record in `spans`, with its enclosing stage and
the counts taken inside it.
"""

from __future__ import annotations

import contextlib
import sys
import time
from dataclasses import dataclass, field

import torch


@dataclass
class Span:
    """One occurrence of a stage: start and end on time.perf_counter(),
    the index in `StageLogger.spans` of the stage it ran in (-1 at the
    top), and the counts recorded while it was the innermost open stage."""
    name: str
    parent: int
    t0: float
    t1: float | None = None
    counters: dict = field(default_factory=dict)


class StageLogger:
    """Stage-scoped stderr logger with wall-clock, stage-record and counter
    telemetry."""

    def __init__(self, out=None):
        self.out = out if out is not None else sys.stderr
        self.timings: dict[str, float] = {}
        self.spans: list[Span] = []
        self._open: list[int] = []   # indices into spans, outermost first
        self.started = time.perf_counter()

    def info(self, msg: str) -> None:
        print(msg, file=self.out, flush=True)

    def counter(self, name: str, value) -> None:
        """Named counter, echoed like the reference's stderr counters and
        kept on the innermost open stage's record."""
        self.count(name, value)
        print(f"{name} = {value}", file=self.out, flush=True)

    def count(self, name: str, value) -> None:
        """A work count kept on the innermost open stage's record and not
        echoed (the reference's log has no such line)."""
        if self._open:
            self.spans[self._open[-1]].counters[name] = (
                value.item() if hasattr(value, "item") else value)

    def reset(self) -> None:
        self.timings.clear()
        self.spans.clear()

    @contextlib.contextmanager
    def stage(self, name: str):
        self.info(f"{name}...")
        t0 = time.perf_counter()
        rec = Span(name, self._open[-1] if self._open else -1, t0)
        self.spans.append(rec)
        self._open.append(len(self.spans) - 1)
        try:
            yield
        finally:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
            rec.t1 = time.perf_counter()
            self._open.pop()
            dt = rec.t1 - t0
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
