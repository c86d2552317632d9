"""BENCHMARK.json against the benchmark's contract, and every name in it
against the files the harness finds by that name."""
import json
import re

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source"}
# the numbers each kind of cell reads; a limit is set on those compared
LIMIT_NAMES = {"train": {"loss_gap", "grad_gap", "grad_mid", "change_gap"},
               "encode": {"clip_gap", "frame_gap"}}


@pytest.fixture(scope="module")
def bench():
    return harness.Bench()


def test_top_level_keys(bench):
    d = bench.data
    assert set(d) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert d["command"] == ["python3", "portbench/run.py"]
    assert d["paths"] == ["portbench"]
    assert isinstance(d["run_seconds"], int) and 1 <= d["run_seconds"] <= 51
    assert len(json.dumps(d)) < 64 * 1024


def test_run_seconds_fits_a_full_check_of_24_cells(bench):
    rs = bench.data["run_seconds"]
    cells = 24
    total = (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_are_valid_and_unique(bench, group):
    names = [e["name"] for e in bench.data[group]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names), names


def test_configs_resolve(bench):
    used = {w["config"] for w in bench.data["workloads"]}
    for c in bench.data["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"].startswith("portbench/configs/")
        spec = bench.spec(c["name"])
        assert spec["name"] == c["name"]
        assert set(c["reduced"]) == set(spec["reduced"])
        assert all(NAME.match(k) for k in c["reduced"])
        harness.make_run(bench, next(w["name"] for w in
                                     bench.data["workloads"]
                                     if w["config"] == c["name"]),
                         0, 1.0, False, "cpu", 0.0)


def test_workloads_resolve(bench):
    pairs = set()
    for w in bench.data["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        run = harness.make_run(bench, w["name"], 0, 1.0, False, "cpu", 0.0)
        __import__(f"portbench.drivers.{run.kind}")
        assert run.limits and set(run.limits) <= LIMIT_NAMES[run.kind]


def test_metrics_resolve_and_cover_every_cell(bench):
    e2e = {m["name"] for m in bench.data["end_to_end"]}
    for m in bench.data["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench.data["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["moves"] in e2e
    for m in bench.data["end_to_end"] + bench.data["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert callable(harness.reader(m["name"]))
    for w in bench.data["workloads"]:
        ends = {m["name"] for m in bench.metrics(w["name"], False)}
        assert "setup_s" in ends and len(ends) >= 2
        layers = bench.metrics(w["name"], True)
        assert layers and all(m["moves"] in ends for m in layers)
