"""The device's side of a traced window, from torch.profiler's CUDA
activity (CUPTI): every kernel, copy and set, put on the host's clock.

The profiler's times start at its own origin. A marker kernel
(`torch.cuda._sleep`, named `spin_kernel`), launched on an idle card
right after a host clock reading, ties the two together: the launch
latency (some microseconds) is the error of that tie, far below the
stages and spans that name the idle gaps. One marker is launched as the
window opens and one as it closes: on an H100 the trace has been seen to
lose the first kernel after the profiler starts (once in ten 51 s
windows, and once in seven one-job traces), so the closing one is used
where it came back, and the opening one otherwise.
"""

from __future__ import annotations

import time

MARKER = "spin_kernel"


def base_name(name: str) -> str:
    """A kernel's name without its namespace marks, return type, argument
    list or template arguments: `(anonymous namespace)::lex_search(Params)`
    is `lex_search`."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[len("void "):]
    return name.split("(")[0].split("<")[0].strip()


class DeviceTrace:
    """torch.profiler over a window; `ops` holds (name, start, end) in
    host-clock seconds once the window is closed."""

    def __init__(self):
        import torch
        self._torch = torch
        self._prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self._mark_host = None
        self._mark_end = None
        self.ops: list[tuple[str, float, float]] = []

    def __enter__(self):
        torch = self._torch
        self._prof.__enter__()
        torch.cuda.synchronize()
        self._mark_host = time.perf_counter()
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
        return self

    def __exit__(self, *exc):
        torch = self._torch
        torch.cuda.synchronize()
        self._mark_end = time.perf_counter()
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._read()
        return False

    def _read(self) -> None:
        from torch.autograd import DeviceType
        dev = [e for e in self._prof.events()
               if e.device_type == DeviceType.CUDA]
        marks = sorted((e for e in dev if MARKER in e.name),
                       key=lambda e: e.time_range.start)
        others = [e for e in dev if MARKER not in e.name]
        if not marks:
            raise RuntimeError("the profiler's trace holds neither marker "
                               f"kernel ({len(dev)} CUDA events)")
        last = marks[-1]
        if not others or last.time_range.start >= max(
                e.time_range.start for e in others):
            origin = self._mark_end - last.time_range.start * 1e-6
        else:
            origin = self._mark_host - marks[0].time_range.start * 1e-6
        self.ops = sorted(
            (base_name(e.name), origin + e.time_range.start * 1e-6,
             origin + e.time_range.end * 1e-6)
            for e in others)


def union_seconds(intervals, lo: float | None = None,
                  hi: float | None = None) -> float:
    """Length of the union of (start, end) intervals, clipped to [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if lo is not None:
            s = max(s, lo)
        if hi is not None:
            e = min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(ops, lo: float, hi: float) -> list[tuple[float, float]]:
    """The spans of [lo, hi] in which no device operation ran."""
    gaps, cur = [], lo
    for _n, s, e in sorted(ops, key=lambda o: o[1]):
        if s > cur:
            gaps.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        gaps.append((cur, hi))
    return [(s, e) for s, e in gaps if e > s]
