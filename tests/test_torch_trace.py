"""The port's stage records (utils/log.py) and the per-layer metrics that
read them (portbench/metrics/), on the CPU.

One `assemble` job at 80 kbp runs under the benchmark's traced-run
recorder (portbench.harness.Recorder), as a `--trace 1` run records it
on the card: every stage it opens must be recorded with its enclosing
stage, the new metrics must read it, and only a sliver of the job's wall
may fall outside every stage and span. One more job, on a 60 kbp genome
with repeat families and a second haplotype (-u 0.1), holds the bubble
stages and the counts of the bubbles and of the contig file.
"""

import torch_threads  # noqa: F401  (first: sets torch's CPU threads)

import contextlib
import io
import json
import math
import os

import pytest
import torch

import simdata
import torch_families
from platanus_b_tpu_torch.commands import assemble_cmd
from platanus_b_tpu_torch.commands.main import main as port_main
from platanus_b_tpu_torch.utils.log import LOG, StageLogger
from portbench import harness

GENOME_BP = 80_000
NEW_METRICS = ["staging_s", "coverage_s", "replay_s", "output_s",
               "bubble_s"]
TOP = "-"   # the parent of a stage opened outside every other stage
# every stage the job opens that a metric, the breakdown or the report
# reads, with the stages it may run in
PARENTS = {
    "staging reads": {TOP},
    "K = 32, graph build": {TOP},
    "removing branches": {TOP, "  cut branch"},
    "removing erroneous nodes": {TOP},
    "removing bubbles": {TOP},
    "  chain pull": {"removing branches", "removing erroneous nodes"},
    "  host replay": {"removing branches", "removing erroneous nodes"},
    "average coverage": {TOP},
    "  bubble mask": {"average coverage"},
    "left minimal coverage": {TOP},
    "    unitig sequences": {"  save contig next-k", "final rebuild"},
    "    kmerize": {"  save contig next-k", "final rebuild"},
    "contigs": {TOP},
    "writing outputs": {TOP},
}


def parent_names(spans):
    """{stage name: the names of the stages it ran in}."""
    out = {}
    for s in spans:
        p = TOP if s.parent < 0 else spans[s.parent].name
        out.setdefault(s.name, set()).add(p)
    return out


# -- the stage logger ----------------------------------------------------------

def test_nested_stages_record_parents_and_counters():
    log = StageLogger(out=io.StringIO())
    with log.stage("outer"):
        log.counter("A", 3)
        with log.stage("inner"):
            log.count("rounds", torch.tensor(7))
            with log.stage("innermost"):
                pass
        log.count("after", 1.5)
    with log.stage("second"):
        pass
    log.counter("OUTSIDE", 1)
    names = [s.name for s in log.spans]
    assert names == ["outer", "inner", "innermost", "second"]
    assert [s.parent for s in log.spans] == [-1, 0, 1, -1]
    assert log.spans[0].counters == {"A": 3, "after": 1.5}
    assert log.spans[1].counters == {"rounds": 7}
    assert type(log.spans[1].counters["rounds"]) is int
    assert log.spans[2].counters == {} and log.spans[3].counters == {}
    for s in log.spans:
        assert s.t0 <= s.t1
    assert log.spans[0].t0 <= log.spans[1].t0 <= log.spans[2].t0
    assert log.spans[2].t1 <= log.spans[1].t1 <= log.spans[0].t1
    assert log.spans[0].t1 <= log.spans[3].t0
    # counter echoes, count does not
    text = log.out.getvalue()
    assert "A = 3" in text and "OUTSIDE = 1" in text
    assert "rounds" not in text and "after" not in text
    assert set(log.timings) == {"outer", "inner", "innermost", "second"}


def test_reset_clears_timings_and_spans():
    log = StageLogger(out=io.StringIO())
    with log.stage("a"):
        with log.stage("b"):
            log.count("n", 1)
    log.reset()
    assert log.timings == {} and log.spans == []
    with log.stage("c"):
        pass
    assert [(s.name, s.parent) for s in log.spans] == [("c", -1)]


def test_stage_wrapped_as_the_harness_wraps_it(monkeypatch):
    monkeypatch.setattr(LOG, "out", io.StringIO())
    LOG.reset()
    with harness.Recorder(set(), {}, lambda: None) as rec:
        with LOG.stage("outer"):
            with LOG.stage("inner"):
                LOG.count("x", 2)
    assert "stage" not in vars(LOG)   # the wrapper is gone again
    assert [n for n, _a, _b in rec.intervals] == ["inner", "outer"]
    assert [(s.name, s.parent, s.counters) for s in LOG.spans] == [
        ("outer", -1, {}), ("inner", 0, {"x": 2})]
    # the harness's interval encloses the logger's record
    by_name = {n: (a, b) for n, a, b in rec.intervals}
    for s in LOG.spans:
        a, b = by_name[s.name]
        assert a <= s.t0 <= s.t1 <= b
    LOG.reset()


def test_rank_report_inside_an_open_stage(monkeypatch):
    """`iterate` runs `assemble` inside its own stage, so the report is
    printed while that stage is open: its end reads null."""
    out = io.StringIO()
    monkeypatch.setattr(LOG, "out", out)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    LOG.reset()
    with LOG.stage("iterate: count kmers"):
        with LOG.stage("staging reads"):
            LOG.count("n", 1)
        assemble_cmd.report_rank()
    line = out.getvalue().strip().splitlines()[-2]
    assert line.startswith("#### DEVICE REPORT #### ")
    report = json.loads(line[len("#### DEVICE REPORT #### "):])
    (n0, p0, a0, b0, c0), (n1, p1, a1, b1, c1) = report["spans"]
    assert (n0, p0, b0, c0) == ("iterate: count kmers", -1, None, {})
    assert (n1, p1, c1) == ("staging reads", 0, {"n": 1})
    assert 0 <= a0 <= a1 <= b1
    LOG.reset()


def test_bubble_record_keeps_the_total(monkeypatch):
    """crush_bubble_iterative echoes each round's count, as the reference
    does, and its record keeps the call's total."""
    from platanus_b_tpu_torch.models import clean
    rounds = iter([2, 1, 0])
    monkeypatch.setattr(clean, "crush_bubble", lambda *a: next(rounds))
    out = io.StringIO()
    monkeypatch.setattr(LOG, "out", out)
    LOG.reset()
    assert clean.crush_bubble_iterative(None, 10.0) == 3
    [rec] = LOG.spans
    assert rec.name == "removing bubbles"
    assert rec.counters == {"NUM_REMOVED_BUBBLES": 3}
    echoed = [ln for ln in out.getvalue().splitlines()
              if ln.startswith("NUM_REMOVED_BUBBLES")]
    assert echoed == [f"NUM_REMOVED_BUBBLES = {n}" for n in (2, 1, 0)]
    LOG.reset()


# -- one traced job ------------------------------------------------------------

@pytest.fixture(scope="module")
def traced_job(tmp_path_factory):
    """One assemble job (-u 0.1, so that bubbles are crushed too) recorded
    as the traced run records it: the stage wrapper and every span and
    call of the cell's per-layer metrics. (Trace, the logger's records,
    the job)."""
    work = str(tmp_path_factory.mktemp("trace"))
    c = harness.cell(harness.benchmark(), "asm-1000k-40x")
    config = dict(c.config, genome_bp=GENOME_BP)
    inputs = harness.make_inputs(config, c.mix, 5, work)
    argv = harness.job_argv(c.mix, inputs.path,
                            os.path.join(work, "job")) + ["-u", "0.1"]
    mods = {m["name"]: harness.load_metric(m["name"]) for m in c.per_layer}
    spans = {s for mod in mods.values() for s in getattr(mod, "SPANS", ())}
    calls = {t: k for mod in mods.values()
             for t, k in getattr(mod, "CALLS", {}).items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PLATANUS_B_TPU_TORCH_DEVICE", "cpu")
        mp.setattr(LOG, "out", io.StringIO())
        with harness.Recorder(spans, calls, lambda: None) as rec:
            jobs, _lo, _hi = harness.window(port_main, lambda i: argv, 0.0,
                                            "cpu", LOG, rec)
        records = list(LOG.spans)
        LOG.reset()
    assert [j.rc for j in jobs] == [0]
    trace = harness.Trace(jobs, [], rec.calls, jobs[0].t0, jobs[-1].t1)
    return trace, records, jobs[0]


@pytest.mark.parametrize("name", sorted(PARENTS))
def test_job_records_stage_with_its_parent(traced_job, name):
    _trace, records, _job = traced_job
    parents = parent_names(records)
    assert name in parents, sorted(parents)
    assert parents[name] <= PARENTS[name], parents[name]
    for s in records:
        if s.name == "  host replay":
            rounds = s.counters["rounds"]
            assert rounds >= 1 and s.counters["elements"] > 0
            assert s.counters["cycle_cuts"] >= 0
            # the junction list, then 2 reads a cut-branch round or 3 a
            # delete iteration
            assert s.counters["reads"] in (1 + 2 * rounds, 1 + 3 * rounds)


def test_job_records_match_the_harness_intervals(traced_job):
    trace, records, job = traced_job
    staged = sorted(n for n, _a, _b in job.intervals
                    if not n.startswith("platanus_b_tpu_torch."))
    assert staged == sorted(s.name for s in records)
    for s in records:
        assert job.t0 <= s.t0 <= s.t1 <= job.t1


@pytest.mark.parametrize("name", NEW_METRICS)
def test_new_metric_reads_the_job(traced_job, name):
    trace, _records, _job = traced_job
    value = harness.load_metric(name).read(trace)
    assert value is not None and 0 < value < trace.jobs[0].wall


def test_untraced_is_a_sliver_of_the_job(traced_job):
    trace, _records, job = traced_job
    assert trace.untraced() < 0.1 * job.wall, (trace.untraced(), job.wall)


def test_rank_report_spans_parse_as_json(traced_job, monkeypatch):
    _trace, records, _job = traced_job
    out = io.StringIO()
    monkeypatch.setattr(LOG, "out", out)
    monkeypatch.setattr(LOG, "spans", records)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assemble_cmd.report_rank()
    line = out.getvalue().strip().splitlines()[-1]
    assert line.startswith("#### DEVICE REPORT #### ")
    report = json.loads(line[len("#### DEVICE REPORT #### "):])
    assert len(report["spans"]) == len(records)
    for (name, parent, t0, t1, counters), s in zip(report["spans"], records):
        assert name == s.name and parent == s.parent
        assert 0 <= t0 <= t1 and counters == s.counters


# -- the bubble stages, on a genome with repeat families ---------------------

BUBBLE_STAGES = ["  bubble pairs", "  bubble align", "  bubble merge"]


def _assemble(argv, out):
    """One port job; (its stage records, its log)."""
    log = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PLATANUS_B_TPU_TORCH_DEVICE", "cpu")
        mp.setattr(LOG, "out", log)
        LOG.reset()
        assert port_main(argv + ["-o", out]) == 0
        records = list(LOG.spans)
        LOG.reset()
    return records, log.getvalue()


@pytest.fixture(scope="module")
def families_job(tmp_path_factory):
    """The families genome with a second haplotype, assembled at -k 32 -u
    0.1: (stage records, log, argv without -o, work directory holding the
    outputs of prefix `job`)."""
    work = tmp_path_factory.mktemp("families")
    simdata.write_fasta(work / "reads.fa",
                        torch_families.families_reads(het=0.005))
    argv = ["assemble", "-f", str(work / "reads.fa"), "-k", "32", "-u", "0.1"]
    records, log = _assemble(argv, str(work / "job"))
    return records, log, argv, work


@pytest.mark.parametrize("name", BUBBLE_STAGES)
def test_bubble_stage_runs_in_removing_bubbles(families_job, name):
    records = families_job[0]
    found = [s for s in records if s.name == name]
    assert found
    for s in found:
        assert records[s.parent].name == "removing bubbles"
        assert records[s.parent].t0 <= s.t0 <= s.t1 <= records[s.parent].t1


def test_crushed_adds_up_to_the_removed_bubbles(families_job):
    records, log, _argv, _work = families_job
    crushed = sum(s.counters["crushed"] for s in records
                  if s.name == "  bubble merge")
    removed = sum(s.counters["NUM_REMOVED_BUBBLES"] for s in records
                  if s.name == "removing bubbles")
    echoed = sum(int(ln.split("=")[1]) for ln in log.splitlines()
                 if ln.startswith("NUM_REMOVED_BUBBLES = "))
    assert crushed == removed == echoed > 0


def test_pair_counts_are_ordered(families_job):
    """aligned <= pairs <= C(candidates, 2) in every crush round."""
    rounds = 0
    for s in families_job[0]:
        if s.name == "  bubble pairs":
            cand, pairs = s.counters["candidates"], s.counters["pairs"]
            assert pairs <= math.comb(cand, 2)
            rounds += 1
        elif s.name == "  bubble align":
            assert 0 < s.counters["aligned"] <= pairs
    assert rounds >= 2   # the last round crushes nothing


def test_contig_counts_match_the_file(families_job):
    records, _log, _argv, work = families_job
    [rec] = [s for s in records if s.name == "writing outputs"]
    names = (work / "job_contig.fa").read_text().split(">")[1:]
    junctions = sum(n.startswith("junction") for n in names)
    assert junctions >= 10
    assert rec.counters == {"records": len(names), "junctions": junctions}
    [avg] = [s for s in records if s.name == "average coverage"]
    assert 0 < avg.counters["bubble_unitigs"] <= avg.counters["unitigs"]


def test_stages_leave_the_outputs_alone(families_job, monkeypatch):
    """The job with the stage clock patched out (no stage, no count)
    writes the same bytes."""
    _records, _log, argv, work = families_job
    monkeypatch.setattr(LOG, "stage", lambda name: contextlib.nullcontext())
    monkeypatch.setattr(LOG, "count", lambda name, value: None)
    records, _ = _assemble(argv, str(work / "bare"))
    assert records == []
    for suffix in ("_contig.fa", "_contigBubble.fa", "_32merFrq.tsv"):
        want = (work / f"job{suffix}").read_bytes()
        assert len(want) > 0 and (work / f"bare{suffix}").read_bytes() == want
