"""BENCHMARK.json's names and units, and the files the harness finds by
name."""

import json
import os
import re
import subprocess
import sys

import pytest

from portbench import harness

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def names():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[key]:
            yield entry["name"]
    for w in BENCH["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in BENCH["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(names())))
def test_name_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25


def test_one_line_texts():
    texts = [w["why"] for w in BENCH["workloads"]]
    texts += [c["source"] for c in BENCH["configs"]]
    texts += [m["layer"] for m in BENCH["per_layer"]] + BENCH["command"]
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t, t
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_files_found_by_name(w):
    c = harness.cell(BENCH, w["name"])
    assert c.config["name"] == w["config"]
    assert os.path.exists(harness.mix_file(w["traffic"]))
    assert "{reads}" in c.mix["argv"] and "{prefix}" in c.mix["argv"]
    assert c.per_layer and [m["name"] for m in c.end_to_end] == ["job_s",
                                                                 "setup_s"]
    for m in c.per_layer:
        assert callable(harness.load_metric(m["name"]).read)


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    data = harness.load_json(os.path.join(harness.ROOT, cfg["file"]))
    assert data["name"] == cfg["name"] and data["reduced"] == cfg["reduced"]
    assert cfg["file"] == f"portbench/configs/{cfg['name']}.json"
    # a configuration that plants repeat families limits their k-mers too
    repeats = {"repeat_kmers_absent_pct"} if data.get("repeats") else set()
    assert set(data["limits"]) == {"mismatch_per_10kbp", "size_gap_pct",
                                   "cov_gap_pct"} | repeats


def test_no_result_without_the_card(tmp_path):
    # only BENCHMARK.json and the benchmark's files: no program, no card
    import shutil
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          BENCH["workloads"][-1]["name"], "--seed", "1",
                          "--seconds", "1"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and res.stdout.strip() == ""
