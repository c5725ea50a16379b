"""The repeat genome's configuration (isolate-4600k-repeats), its cell
and the bubble_s reader."""

import numpy as np
import pytest

from portbench import check, gen, harness

BENCH = harness.benchmark()
CELL = "asm-4600k-rep-40x"


def test_config_loads_through_the_harness():
    c = harness.cell(BENCH, CELL)
    assert c.config["name"] == "isolate-4600k-repeats"
    assert c.mix_name == "reads125-40x" and c.chips == 1
    assert c.config["genome_bp"] == 4_600_000
    assert c.config["dataset_seed"] == 123 and c.config["reduced"] == []
    assert "upstream" not in c.config
    fams = {f["name"]: (f["copies"], f["length"], f["divergence"])
            for f in c.config["repeats"]}
    assert fams == {"rrn": (7, 5000, 0.002), "IS5": (11, 1195, 0.0),
                    "IS2": (6, 1331, 0.0), "IS1": (7, 768, 0.0),
                    "IS3": (5, 1258, 0.0), "IS30": (3, 1221, 0.0),
                    "IS186": (3, 1338, 0.0)}
    assert all(f["reverse_share"] == 0.5 for f in c.config["repeats"])
    assert len(c.config["source"]) <= 200


def test_copies_fit_the_genome_a_read_apart():
    c = harness.cell(BENCH, CELL)
    genome = np.zeros(c.config["genome_bp"], np.uint8)
    planted, plan = gen.plant_repeats(genome, c.config["repeats"],
                                      c.config["dataset_seed"],
                                      c.mix["read_len"])
    assert len(plan.copies) == 42
    assert sum(cp.length for cp in plan.copies) == 75_474
    slots = sorted((cp.start, cp.start + cp.length) for cp in plan.copies)
    assert slots[0][0] >= 0 and slots[-1][1] <= len(genome)
    for (_a, end), (start, _b) in zip(slots, slots[1:]):
        assert start - end >= c.mix["read_len"]
    for cp, seq in zip(plan.copies, plan.sequences(planted)):
        assert len(seq) == cp.length


def test_limits_hold_the_repeat_number():
    limits = harness.cell(BENCH, CELL).config["limits"]
    assert set(limits) == {"mismatch_per_10kbp", "size_gap_pct",
                           "cov_gap_pct", check.REPEAT}
    assert 0 < limits[check.REPEAT] < 100


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_every_metric_lists_the_cell(metric):
    assert CELL in metric["workloads"]


def _trace(intervals):
    job = harness.Job(2.0, 0.0, 2.0, 0, 0, intervals=intervals)
    return harness.Trace([job], [], {}, 0.0, 2.0)


def test_bubble_s_reads_the_stage_union():
    bubble_s = harness.load_metric("bubble_s")
    assert bubble_s.read(_trace([
        ("average coverage", 0.0, 0.5), ("  bubble mask", 0.1, 0.3),
        ("removing bubbles", 1.0, 1.6), ("  bubble pairs", 1.0, 1.2),
        ("  bubble align", 1.2, 1.4), ("  bubble merge", 1.4, 1.5),
        ("contigs", 1.7, 1.9)])) == pytest.approx(0.2 + 0.6)
    assert bubble_s.read(_trace([("average coverage", 0.0, 0.5),
                                 ("contigs", 1.7, 1.9)])) is None


def test_repeats_dropped_leaves_out_the_high_coverage_records():
    from portbench import repeat_control
    contigs, covs = repeat_control.drop_repeats(
        lambda dbg, ratio: (["a", "b", "c", "d"], [10.0, 11.0, 40.0, 9.0]))(
            None, 1.0)
    assert contigs == ["a", "b", "d"] and covs == [10.0, 11.0, 9.0]
