"""The check that decides `correct`, driven through a whole run on the
CPU at a small genome (the look for a card skipped): a sound run is
correct; the controls and each fault the cells can have, planted in the
timed path, make it false."""

import contextlib
import copy
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
def test_traced_run_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
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
