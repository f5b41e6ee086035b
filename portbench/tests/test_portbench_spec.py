"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

import json
import math
import re

import pytest

from portbench.core import spec

BENCH = spec.load_bench()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + \
        [m["name"] for m in METRICS]
    names += [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    for name in names:
        assert spec.NAME_RE.fullmatch(name), name
    for m in METRICS:
        assert spec.UNIT_RE.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in spec.SOURCES
    lines = [c["source"] for c in BENCH["configs"]] + \
        [w["why"] for w in BENCH["workloads"]] + \
        [c["why"] for c in BENCH["configs"]] + \
        [m["layer"] for m in BENCH["per_layer"]] + BENCH["command"]
    for line in lines:
        assert spec.LINE_RE.fullmatch(line), line
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        assert len({x["name"] for x in group}) == len(group)


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= \
        max(1, len(CELLS) // 4)


def test_check_fits_the_budget_with_24_cells():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_and_a_layer(cell):
    c = spec.load_cell(cell)
    e2e = [m["name"] for m in c.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_layer_metric_cells_report_what_it_moves(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    e2e = {x["name"]: x for x in BENCH["end_to_end"]}
    assert m["moves"] in e2e
    cells = m["workloads"]
    assert cells
    for cell in cells:
        assert cell in CELLS
        assert spec.reports(e2e[m["moves"]], cell)
    assert hasattr(spec.reader(metric), "read")


def test_layers_named_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers == {"step", "recurrent stack and GRU kernels", "device"}


@pytest.mark.parametrize("cell", CELLS)
def test_every_file_found_by_name(cell):
    c = spec.load_cell(cell)
    assert spec.family(c.config) and spec.loop(c.traffic)
    ref = spec.reference(c.config)
    assert callable(ref.leaves)
    assert c.limits, "each cell has its limits"
    for v in c.limits.values():
        assert isinstance(v, (int, float)) and math.isfinite(v)
    for m in c.config["rnn_modules"]:
        assert re.fullmatch(r"[a-z_.0-9]+", m)


def test_config_files_are_distinct_and_under_paths():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for f in files:
        assert f.startswith("portbench/")
        json.loads((spec.ROOT / f).read_text())
