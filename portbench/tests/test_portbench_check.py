"""The check that decides `correct`, driven through a whole run on the
CPU at a small genome (the look for a card skipped): a sound run is
correct; the controls and each fault the cells can have, planted in the
timed path, make it false."""

import contextlib
import copy
import json
import os

import numpy as np
import pytest
import torch

from portbench import control, harness

GENOME_BP = 60_000


def small_cell(workload="asm-1000k-40x", genome_bp=GENOME_BP):
    c = harness.cell(harness.benchmark(), workload)
    c = copy.copy(c)
    c.config = dict(c.config, genome_bp=genome_bp, upstream={})
    return c


def run(tmp_path, plant=None, seed=11, seconds=0.0, trace=False, cell=None):
    work = str(tmp_path / "work")
    os.makedirs(work, exist_ok=True)
    import time
    return harness.run_cell(cell or small_cell(), seed, seconds, trace, "cpu",
                            work, time.perf_counter(), plant=plant)


def flip_longest(orig):
    def contigs_of(dbg, ratio):
        contigs, covs = orig(dbg, ratio)
        i = int(np.argmax([len(s) for s in contigs]))
        s = contigs[i].copy()
        s[len(s) // 2] = (s[len(s) // 2] + 1) % 4
        contigs[i] = s
        return contigs, covs
    return contigs_of


def cov_off(orig):
    def contigs_of(dbg, ratio):
        contigs, covs = orig(dbg, ratio)
        i = int(np.argmax([len(s) for s in contigs]))
        covs = list(covs)
        covs[i] *= 1.5
        return contigs, covs
    return contigs_of


def half_reads(orig):
    def stage(batches, device):
        staged = orig(batches, device)
        return staged.select(torch.arange(staged.num_reads) % 2 == 0)
    return stage


def one_row_off(orig):
    def write(path, hist):
        hist = np.array(hist)
        hist[2] += 1
        return orig(path, hist)
    return write


def second_job_differs(orig):
    calls = [0]

    def contigs_of(dbg, ratio):
        calls[0] += 1
        out = orig(dbg, ratio)
        return flip_longest(lambda d, r: out)(dbg, ratio) if calls[0] == 2 \
            else out
    return contigs_of


def no_extension(orig):
    def schedule(min_log_p, cov, length, min_cov, k0, cutoff0, *rest):
        return [k0], [cutoff0]
    return schedule


FAULTS = {
    # a step that returns its state unchanged
    "no_error_removal": ("platanus_b_tpu_torch.models.clean:"
                         "delete_erroneous_iterative",
                         lambda orig: (lambda *a, **kw: 0)),
    "no_k_extension": ("platanus_b_tpu_torch.models.assemble_core:"
                       "extend_kmer_schedule", no_extension),
    # half of the batch left out
    "half_the_reads": ("platanus_b_tpu_torch.models.assemble_core:stage_reads",
                       half_reads),
    # an answer altered where it is produced
    "contig_base_flipped": ("platanus_b_tpu_torch.models.assemble_core:"
                            "_contigs_of", flip_longest),
    "coverage_off": ("platanus_b_tpu_torch.models.assemble_core:"
                     "_contigs_of", cov_off),
    "distribution_row_off": ("platanus_b_tpu_torch.ops.count:"
                             "write_occurrence_tsv", one_row_off),
    "second_job_differs": ("platanus_b_tpu_torch.models.assemble_core:"
                           "_contigs_of", second_job_differs),
}
FAILS = {"no_error_removal": {"mismatch_per_10kbp", "size_gap_pct"},
         "no_k_extension": {"header_off"},
         "half_the_reads": {"frq_rows_off"},
         "contig_base_flipped": {"unread_kmers"},
         "coverage_off": {"cov_gap_pct"},
         "distribution_row_off": {"frq_rows_off"},
         "second_job_differs": {"jobs_unlike_first"}}


def failing(result):
    return {k for k, v in result["checks"].items()
            if v["value"] is None or v["value"] > v["limit"]}


def test_sound_run_is_correct(tmp_path):
    r = run(tmp_path, seconds=0.0)
    assert r["correct"] and not failing(r)
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {"job_s", "setup_s"}


def test_traced_run_reads_the_host_layers(tmp_path):
    r = run(tmp_path, trace=True)
    assert r["correct"]
    m = r["metrics"]
    assert {"ingest_s", "count_s", "graph_s", "clean_s", "kext_s",
            "untraced_s"} <= set(m)
    # no card: no device metric is written
    assert not {"k2_roofline", "graph_kernels_roofline", "device_idle",
                "peak_device_gib"} & set(m)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_caught(tmp_path, fault):
    target, make = FAULTS[fault]
    # two jobs where the fault is in the second
    seconds = 10.0 if fault == "second_job_differs" else 0.0
    r = run(tmp_path, seconds=seconds,
            plant=lambda inputs: harness.patched(target, make))
    assert r["attempted"] >= (2 if seconds else 1)
    assert not r["correct"]
    assert FAILS[fault] <= failing(r), failing(r)


@pytest.mark.parametrize("name", sorted(control.CONTROLS))
def test_control_fails(tmp_path, name):
    cell = small_cell(genome_bp=150_000 if name == "hashed_count" else GENOME_BP)
    r = run(tmp_path, cell=cell,
            plant=lambda inputs: control.CONTROLS[name](inputs, "cpu"))
    assert not r["correct"]
    want = {"hashed_count": {"frq_rows_off"},
            "no_error_removal": {"mismatch_per_10kbp", "size_gap_pct"},
            "bf16_unitig_sums": {"cov_gap_pct"}}[name]
    assert want <= failing(r), failing(r)


@pytest.mark.cuda
def test_traced_run_on_the_card(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # conftest.py puts the port on the CPU for the other tests
    monkeypatch.setenv("PLATANUS_B_TPU_TORCH_DEVICE", "cuda")
    import time
    work = str(tmp_path / "work")
    os.makedirs(work)
    r = harness.run_cell(small_cell(genome_bp=200_000), 5, 1.0, True, "cuda",
                         work, time.perf_counter())
    assert r["correct"]
    m = r["metrics"]
    assert 0 < m["k2_roofline"]["value"] <= 105
    assert 0 < m["device_idle"]["value"] < 100
    assert 0 < r["device"]["busy_s"] < r["device"]["window_s"]
    with contextlib.suppress(KeyError):
        assert len(r["breakdown"]["device_ops"]) <= 10


# two families on a genome of 150 kbp: exact rRNA-like copies and
# IS-like ones at 1 % divergence, half of each reverse-complemented
REPEATS = [
    {"name": "rrn", "copies": 3, "length": 1_500, "divergence": 0.0,
     "reverse_share": 0.5},
    {"name": "IS", "copies": 4, "length": 700, "divergence": 0.01,
     "reverse_share": 0.5}]


def repeat_cell():
    c = small_cell(genome_bp=150_000)
    c.config = dict(c.config, repeats=REPEATS, limits=dict(
        c.config["limits"], repeat_kmers_absent_pct=5.0))
    return c


def drop_repeats(orig):
    def contigs_of(dbg, ratio):
        contigs, covs = orig(dbg, ratio)
        keep = np.asarray(covs) <= 2 * np.median(covs)
        return ([s for s, ok in zip(contigs, keep) if ok],
                [v for v, ok in zip(covs, keep) if ok])
    return contigs_of


def test_record_of_a_divergent_copy_reads_no_mismatch():
    # a record cut from copy 3 of a family at 1 % divergence lies exactly
    # on that copy, whichever copy its anchors find first in the index
    from portbench import gen
    from portbench import reference as ref
    genome, _reads, plan = gen.simulate_planted(
        100_000, 125, 1, 0.003, 5, [dict(REPEATS[1], copies=5, length=1_500)])
    text = gen.BASES[genome].tobytes()
    c = plan.copies[3]
    piece = text[c.start + 200: c.start + 900]
    recs = [piece, ref.revcomp(piece), text[c.start: c.start + c.length]]
    assert ref.GenomeIndex(text).mismatches(recs) == [0, 0, 0]


def test_absent_share_of_repeat_kmers():
    import torch

    from portbench import reference as ref
    a = ref.distinct_kmers([b"ACGTTGCA" * 8, b"A" * 40], 32, "cpu")
    b = ref.distinct_kmers([b"ACGTTGCA" * 8], 32, "cpu")
    assert ref.absent_share(a, b) == pytest.approx(100.0 / a.numel())
    assert ref.absent_share(a, a) == 0.0
    assert ref.absent_share(a, torch.zeros(0, dtype=torch.int64)) == 100.0
    assert ref.distinct_kmers([b"ACGTN" * 10], 32, "cpu").numel() == 0


def test_sound_run_on_a_repeat_genome_is_correct(tmp_path):
    r = run(tmp_path, cell=repeat_cell())
    assert r["correct"] and not failing(r)
    assert list(r["checks"]) == ["failed_jobs", "jobs_unlike_first",
                                 "frq_rows_off", "unread_kmers", "header_off",
                                 "mismatch_per_10kbp", "size_gap_pct",
                                 "cov_gap_pct", "repeat_kmers_absent_pct"]
    assert r["checks"]["repeat_kmers_absent_pct"]["value"] == 0.0


def test_repeats_dropped_is_caught(tmp_path):
    # a fault the repeat genome's cells can have: every record at more
    # than twice the median coverage left out of the contig file
    r = run(tmp_path, cell=repeat_cell(), plant=lambda inputs: harness.patched(
        "platanus_b_tpu_torch.models.assemble_core:_contigs_of", drop_repeats))
    assert not r["correct"]
    assert "repeat_kmers_absent_pct" in failing(r), r["checks"]


def test_repeats_need_their_limit(tmp_path, monkeypatch):
    cfg = dict(repeat_cell().config)
    del cfg["limits"]["repeat_kmers_absent_pct"]
    (tmp_path / "rep.json").write_text(json.dumps(cfg))
    monkeypatch.setattr(harness, "config_file",
                        lambda name: str(tmp_path / f"{name}.json"))
    bench = {"workloads": [{"name": "w", "config": "rep",
                            "traffic": "reads125-40x", "chips": 1}],
             "end_to_end": [], "per_layer": []}
    with pytest.raises(SystemExit):
        harness.cell(bench, "w")
