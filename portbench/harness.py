"""One run of a cell: set-up, the measured window of jobs, the traced
window's per-layer metrics, and the check.

Everything that belongs to one configuration, mix or per-layer metric is
a file of its own, found by the name BENCHMARK.json gives it:
`configs/<config>.json`, `mixes/<traffic>.json`, `metrics/<metric>.py`.
"""

from __future__ import annotations

import contextlib
import fnmatch
import gc
import hashlib
import importlib
import importlib.util
import io
import json
import os
import sys
import time
import traceback
from dataclasses import dataclass, field

import numpy as np

from . import bounds, check, gen
from .devtrace import DeviceTrace, idle_gaps, union_seconds

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "platanus_b_tpu")


# -- the data files -----------------------------------------------------------

def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def config_file(name: str) -> str:
    return os.path.join(HERE, "configs", f"{name}.json")


def mix_file(name: str) -> str:
    return os.path.join(HERE, "mixes", f"{name}.json")


def metric_file(name: str) -> str:
    return os.path.join(HERE, "metrics", f"{name}.py")


def load_metric(name: str):
    """metrics/<name>.py as a module (its file name need not be a valid
    module name)."""
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"),
        metric_file(name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    mix_name: str
    end_to_end: list
    per_layer: list


def cell(bench: dict, workload: str) -> Cell:
    """The cell `workload` of BENCHMARK.json with its configuration, its
    mix and the metrics it reports."""
    found = [w for w in bench["workloads"] if w["name"] == workload]
    if not found:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    w = found[0]
    config = load_json(config_file(w["config"]))
    if config.get("repeats") and check.REPEAT not in config["limits"]:
        raise SystemExit(f"configuration {w['config']!r} plants repeats and "
                         f"has no limit for {check.REPEAT}")

    def here(m):
        return "workloads" not in m or workload in m["workloads"]
    return Cell(workload, int(w["chips"]), config,
                load_json(mix_file(w["traffic"])), w["traffic"],
                [m for m in bench["end_to_end"] if here(m)],
                [m for m in bench["per_layer"] if here(m)])


# -- inputs -------------------------------------------------------------------

@dataclass
class Inputs:
    genome: np.ndarray
    reads: np.ndarray
    path: str
    plan: gen.Plan = field(default_factory=gen.Plan)

    @property
    def genome_text(self) -> bytes:
        return gen.BASES[self.genome].tobytes()


def dataset(config: dict, mix: dict, seed: int):
    """(genome, reads, plan): the configuration's genome drawn from `seed`
    with its `repeats` families planted (none where it has no such key),
    and the mix's reads of it."""
    return gen.simulate_planted(config["genome_bp"], mix["read_len"],
                                mix["coverage"], mix["error"], seed,
                                config.get("repeats", ()))


def make_inputs(config: dict, mix: dict, seed: int, work: str) -> Inputs:
    """The window's inputs: the configuration's genome and the mix's
    reads, both from the configuration's dataset seed, written in an order
    drawn from `seed`. Every seed gives the window the same work (the
    outputs do not depend on the order)."""
    genome, reads, plan = dataset(config, mix, config["dataset_seed"])
    path = os.path.join(work, "reads.fa")
    gen.write_fasta(path, reads[gen.rng_of(seed).permutation(len(reads))])
    return Inputs(genome, reads, path, plan)


def seed_inputs(config: dict, mix: dict, seed: int, work: str) -> Inputs:
    """The checked job's inputs: a genome of the configuration's size, with
    a repeat layout of its own, and the mix's reads of it, all drawn from
    the run's seed, so that each seed's check reads a dataset of its own."""
    genome, reads, plan = dataset(config, mix, seed)
    path = os.path.join(work, "seed_reads.fa")
    gen.write_fasta(path, reads)
    return Inputs(genome, reads, path, plan)


def job_argv(mix: dict, reads: str, prefix: str) -> list[str]:
    return [a.replace("{reads}", reads).replace("{prefix}", prefix)
            for a in mix["argv"]]


def mix_k(mix: dict) -> int:
    argv = mix["argv"]
    return int(argv[argv.index("-k") + 1])


# -- tracing (the traced run only) ---------------------------------------------

@contextlib.contextmanager
def patched(target: str, make):
    """`module:attr` replaced by make(original) for the block."""
    mod_name, attr = target.split(":")
    mod = importlib.import_module(mod_name)
    orig = getattr(mod, attr)
    setattr(mod, attr, make(orig))
    try:
        yield
    finally:
        setattr(mod, attr, orig)


@dataclass
class Job:
    wall: float
    t0: float
    t1: float
    rc: int
    peak_bytes: int
    intervals: list = field(default_factory=list)   # (name, t0, t1)
    stages: dict = field(default_factory=dict)


class Recorder:
    """Benchmark-side spans and call records, installed on the port's
    module attributes for the traced window: the stage clock's stages
    (`LOG.stage`, recorded under the stage's name), the `module:function`
    spans the metrics ask for (a device sync at each end, recorded under
    that target string), and the kernel launchers whose calls' bytes the
    metrics read (`bounds.BYTES`)."""

    def __init__(self, spans: set, calls: dict, sync):
        self.spans, self.calls_wanted, self.sync = spans, calls, sync
        self.intervals: list = []
        self.calls: dict[str, list] = {name: [] for name in calls.values()}
        self._stack = contextlib.ExitStack()

    def _stage_wrapper(self, orig):
        rec = self.intervals

        @contextlib.contextmanager
        def stage(name):
            t0 = time.perf_counter()
            try:
                with orig(name):
                    yield
            finally:
                rec.append((name, t0, time.perf_counter()))
        return stage

    def _span_wrapper(self, name, orig):
        rec, sync = self.intervals, self.sync

        def span(*args, **kwargs):
            sync()
            t0 = time.perf_counter()
            try:
                return orig(*args, **kwargs)
            finally:
                sync()
                rec.append((name, t0, time.perf_counter()))
        return span

    def _call_wrapper(self, key, orig):
        rec, fn = self.calls[key], bounds.BYTES[key]

        def call(*args, **kwargs):
            rec.append(fn(*args, **kwargs))
            return orig(*args, **kwargs)
        return call

    def __enter__(self):
        from platanus_b_tpu_torch.utils.log import LOG
        LOG.stage = self._stage_wrapper(type(LOG).stage.__get__(LOG))
        self._stack.callback(delattr, LOG, "stage")
        for target in sorted(self.spans):
            self._stack.enter_context(patched(
                target, lambda orig, t=target: self._span_wrapper(t, orig)))
        for target, key in sorted(self.calls_wanted.items()):
            self._stack.enter_context(patched(
                target, lambda orig, k=key: self._call_wrapper(k, orig)))
        return self

    def __exit__(self, *exc):
        self._stack.close()
        return False


class Trace:
    """What a per-layer metric reads: the window's jobs (wall, peak, the
    stages and spans inside each), the device's operations on the host
    clock, and the bytes of each recorded kernel call."""

    def __init__(self, jobs, ops, calls, lo, hi):
        self.jobs, self.ops, self.calls = jobs, ops, calls
        self.window = (lo, hi)

    def per_job_union(self, patterns) -> float | None:
        """Mean over jobs of the time the named stages and spans cover
        (a span is named by its `module:function` target)."""
        if not self.jobs:
            return None
        seen = False
        total = 0.0
        for j in self.jobs:
            iv = [(a, b) for n, a, b in j.intervals
                  if any(fnmatch.fnmatchcase(n, p) for p in patterns)]
            seen |= bool(iv)
            total += union_seconds(iv)
        return total / len(self.jobs) if seen else None

    def untraced(self) -> float | None:
        if not self.jobs:
            return None
        return sum(j.wall - union_seconds([(a, b) for _n, a, b in j.intervals],
                                          j.t0, j.t1)
                   for j in self.jobs) / len(self.jobs)

    def device_seconds(self, names) -> float:
        return sum(e - s for n, s, e in self.ops if n in names)

    def busy_s(self) -> float:
        return union_seconds([(s, e) for _n, s, e in self.ops], *self.window)

    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def roofline_pct(self, keys, kernel_names) -> float | None:
        """Share (%) of the bytes bound of the recorded calls `keys` in
        the device time of the kernels `kernel_names`."""
        n_bytes = sum(sum(self.calls.get(k, [])) for k in keys)
        dev = self.device_seconds(kernel_names)
        if not n_bytes or dev <= 0:
            return None
        return 100.0 * n_bytes / bounds.HBM_BYTES_S / dev

    def host_name_at(self, t: float) -> str:
        """The innermost stage or span open at host time t."""
        for j in self.jobs:
            if j.t0 <= t <= j.t1:
                inside = [(b - a, n) for n, a, b in j.intervals if a <= t <= b]
                return min(inside)[1] if inside else "untraced"
        return "between jobs"

    def breakdown(self) -> dict:
        by_op: dict[str, float] = {}
        for n, s, e in self.ops:
            by_op[n] = by_op.get(n, 0.0) + (e - s)
        idle: dict[str, float] = {}
        for s, e in idle_gaps(self.ops, *self.window):
            name = self.host_name_at(0.5 * (s + e)).strip()
            idle[name] = idle.get(name, 0.0) + (e - s)
        top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                                   key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(by_op), "idle_gaps": top(idle)}


# -- the run ---------------------------------------------------------------------

class _Discard(io.TextIOBase):
    """Where the port's stage log goes during a run: nowhere."""

    def write(self, s: str) -> int:
        return len(s)


def _sync_fn(device: str):
    if device == "cuda":
        import torch
        return torch.cuda.synchronize
    return lambda: None


def top_stages(timings: dict) -> dict:
    return {k: round(v, 3) for k, v in timings.items() if not k.startswith(" ")}


def run_job(cli_main, argv, device, log) -> Job:
    import torch
    log.reset()
    cuda = device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        rc = cli_main(argv)
    except Exception:  # noqa: BLE001 - a job that raises counts as failed
        traceback.print_exc()
        rc = -1
    if cuda:
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    job = Job(t1 - t0, t0, t1, int(rc), int(peak))
    job.stages = top_stages(log.timings)
    return job


def window(cli_main, argv_of, seconds: float, device, log, recorder=None):
    """Jobs one after another until `seconds` have passed: (jobs, start,
    end), the window closing when the last job ends."""
    jobs: list[Job] = []
    start = time.perf_counter()
    while True:
        first = len(recorder.intervals) if recorder else 0
        job = run_job(cli_main, argv_of(len(jobs)), device, log)
        if recorder:
            job.intervals = recorder.intervals[first:]
        jobs.append(job)
        if time.perf_counter() - start >= seconds:
            break
    return jobs, start, time.perf_counter()


def file_digest(path: str) -> str | None:
    if not os.path.exists(path):
        return None
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(c: Cell, seed: int, seconds: float, trace: bool, device: str,
             work: str, setup_t0: float, log=sys.stderr,
             plant=None) -> dict:
    """One run of cell `c` in the scratch directory `work`; returns the
    result's fields, "checks" last. `plant(inputs)`, a context manager,
    is held around the window and around the checked job on the seed's
    dataset, with the inputs of the jobs it holds: the control and the
    fault tests use it to break the timed path."""
    import torch

    from platanus_b_tpu_torch import kernels
    from platanus_b_tpu_torch.commands.main import main as cli_main
    from platanus_b_tpu_torch.utils.log import LOG
    LOG.out = _Discard()
    cuda = device == "cuda"
    t_import = time.perf_counter()
    if cuda:
        kernels.library()
    t_lib = time.perf_counter()
    inputs = make_inputs(c.config, c.mix, seed, work)
    t_inputs = time.perf_counter()
    warm = run_job(cli_main, job_argv(c.mix, inputs.path,
                                      os.path.join(work, "warmup")),
                   device, LOG)
    if warm.rc != 0:
        raise RuntimeError(f"the warm-up job exited {warm.rc}")
    for suffix in c.mix["outputs"]:
        with contextlib.suppress(FileNotFoundError):
            os.remove(os.path.join(work, "warmup" + suffix))
    setup_s = time.perf_counter() - setup_t0
    print(f"set-up {setup_s:.3f} s: start and imports "
          f"{t_import - setup_t0:.3f}, kernel library {t_lib - t_import:.3f} "
          f"(compiled: {kernels.BUILD_INFO.get('compiled')}), reads "
          f"{t_inputs - t_lib:.3f}, warm-up job {warm.wall:.3f}", file=log)
    def planted_for(inp):
        return plant(inp) if plant is not None else contextlib.nullcontext()
    planted = planted_for(inputs)

    prefixes = []

    def argv_of(i):
        prefixes.append(os.path.join(work, f"job{i}"))
        return job_argv(c.mix, inputs.path, prefixes[-1])

    metrics, device_trace, breakdown = {}, {}, {}
    if trace:
        mods = {m["name"]: load_metric(m["name"]) for m in c.per_layer}
        spans = {s for mod in mods.values() for s in getattr(mod, "SPANS", ())}
        calls = {t: k for mod in mods.values()
                 for t, k in getattr(mod, "CALLS", {}).items()}
        with planted, Recorder(spans, calls, _sync_fn(device)) as rec:
            dtrace = DeviceTrace() if cuda else contextlib.nullcontext()
            with dtrace:
                jobs, lo, hi = window(cli_main, argv_of, seconds, device, LOG,
                                      rec)
        tr = Trace(jobs, getattr(dtrace, "ops", []), rec.calls,
                   jobs[0].t0, jobs[-1].t1)
        for m in c.per_layer:
            value = mods[m["name"]].read(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        print("recorded calls: " + ", ".join(
            f"{k} {len(v)} calls {sum(v)} bytes" for k, v in rec.calls.items()),
            file=log)
        if cuda:
            breakdown = {"breakdown": tr.breakdown()}
            device_trace = {"busy_s": tr.busy_s(), "window_s": tr.window_s()}
    else:
        with planted:
            jobs, lo, hi = window(cli_main, argv_of, seconds, device, LOG)
        values = {"job_s": (hi - lo) / len(jobs), "setup_s": setup_s}
        for m in c.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    peak = max(j.peak_bytes for j in jobs)
    print(f"window: {len(jobs)} jobs in {hi - lo:.3f} s; job walls "
          + " ".join(f"{j.wall:.3f}" for j in jobs), file=log)
    print(f"stages of the warm-up job {json.dumps(warm.stages)}, of the "
          f"last job {json.dumps(jobs[-1].stages)}", file=log)

    # the check, once the window has closed: the first job's files, and
    # one more job's on a dataset drawn from the seed; then the port's
    # state is freed and the reference judges both
    t_check = time.perf_counter()
    own = seed_inputs(c.config, c.mix, seed, work)
    seed_prefix = os.path.join(work, "seedjob")
    with planted_for(own):
        seed_job = run_job(cli_main, job_argv(c.mix, own.path, seed_prefix),
                           device, LOG)
    t_seed = time.perf_counter()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    digests = [[file_digest(p + s) for s in c.mix["outputs"]]
               for p in prefixes]
    failed = sum(j.rc != 0 for j in jobs)
    numbers = {"failed_jobs": failed + (seed_job.rc != 0),
               "jobs_unlike_first": sum(d != digests[0] for d in digests)}
    upstream = c.config.get("upstream", {}).get(c.mix_name)
    for label, prefix, inp, up in (("window", prefixes[0], inputs, upstream),
                                   ("seed", seed_prefix, own, None)):
        files = {s: prefix + s for s in c.mix["outputs"]}
        try:
            judged, info = check.judge(files, inp, mix_k(c.mix), device, up)
            print(f"reference, {label} dataset: " + json.dumps(
                {**info, **judged}), file=log)
        except (OSError, ValueError, KeyError) as e:
            print(f"check: the {label} job's outputs could not be read: "
                  f"{e!r}", file=log)
            judged = dict.fromkeys(check.judged_names(inp))
        numbers = check.worst(numbers, judged)
    correct, checks = check.verdict(numbers, c.config["limits"])
    print(f"the check took {time.perf_counter() - t_check:.3f} s (the "
          f"seed's dataset and its job {t_seed - t_check:.3f}, the job "
          f"{seed_job.wall:.3f})", file=log)
    for p in prefixes + [seed_prefix]:
        for s in c.mix["outputs"]:
            with contextlib.suppress(FileNotFoundError):
                os.remove(p + s)
    result = {
        "correct": bool(correct), "attempted": len(jobs), "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": c.chips if cuda else 0,
                   "memory_peak_bytes": int(peak), **device_trace},
        **breakdown, "checks": checks}
    return result
