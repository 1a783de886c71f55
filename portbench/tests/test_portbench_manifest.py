"""BENCHMARK.json against its schema: keys, names, units and
characters, and every cell's files found by name."""
import json
import re
from pathlib import Path

import pytest

from portbench import harness, traffic_gen
from portbench.reference import dfp

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
METRIC_KEYS = {"name", "unit", "better", "source"}


def one_line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)


def test_command_and_paths():
    paths = BENCH["paths"]
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(one_line(w) for w in cmd)
    for word in cmd:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in paths), word
            assert not word.startswith("/") and ".." not in word


def test_names_are_unique_and_well_formed():
    groups = (BENCH["configs"], BENCH["workloads"],
              BENCH["end_to_end"] + BENCH["per_layer"])
    for group in groups:
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert one_line(c["source"]) and one_line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert dfp.parameter_count(cfg) == cfg["parameters"]
        assert harness.ref_layout(cfg).state_dim == cfg["state_dim"]


def test_workloads_find_their_files():
    assert 1 <= len(BENCH["workloads"]) <= 24
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and one_line(w["why"])
        cell = harness.load_cell(ROOT, w["name"])
        harness.check_cell(cell.config, cell.mix)
        assert harness.traffic_file(ROOT, w["traffic"]).suffix in (
            ".json", ".jsonl", ".toml", ".txt", ".csv")
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer


@pytest.mark.parametrize("metric", BENCH["end_to_end"],
                         ids=lambda m: m["name"])
def test_end_to_end_metric(metric):
    assert set(metric) - {"workloads"} == METRIC_KEYS | {"bound"}
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower",
                                                               "higher")
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_metric_has_a_reader(metric):
    assert set(metric) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower",
                                                               "higher")
    assert metric["source"] in SOURCES and one_line(metric["layer"])
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if metric["name"].endswith("_roofline") or "_roofline." in \
            metric["name"] or "mfu" in metric["name"]:
        assert metric["unit"] == "%"
    assert callable(harness.metric_reader(ROOT, metric["name"]))


def test_layer_names_are_in_perf_md():
    perf = (ROOT / "PERF.md").read_text()
    for m in BENCH["per_layer"]:
        assert f"| {m['layer']} |" in perf, m["layer"]


def test_check_budget_fits_at_24_cells():
    per_run = BENCH["run_seconds"] + 60
    cells = 24
    total = (2 + 14 * cells) * per_run + cells * 2 * 90 + 1200
    assert total <= 43200


def test_traffic_mixes_load():
    for w in BENCH["workloads"]:
        mix = traffic_gen.load_mix(harness.traffic_file(ROOT, w["traffic"]))
        assert mix["n_traces"] >= 1 and mix["time_resolution_s"] == 1
