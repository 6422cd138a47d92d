"""``BENCHMARK.json`` keeps to the contract's forms, and every name in it
is found as a file of the benchmark."""

import importlib
import json
import os
import re

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_and_units():
    names = ([m["name"] for m in METRICS]
             + [w["name"] for w in BENCH["workloads"]]
             + [c["name"] for c in BENCH["configs"]]
             + [w["config"] for w in BENCH["workloads"]]
             + [w["traffic"] for w in BENCH["workloads"]]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), names
    for group in (METRICS, BENCH["workloads"], BENCH["configs"]):
        assert len({m["name"] for m in group}) == len(group)
    assert all(UNIT.match(m["unit"]) for m in METRICS)
    assert all(m["better"] in ("lower", "higher") for m in METRICS)


def test_lines_and_paths():
    texts = ([w["why"] for w in BENCH["workloads"]]
             + [c["why"] for c in BENCH["configs"]]
             + [c["source"] for c in BENCH["configs"]]
             + [m["layer"] for m in BENCH["per_layer"]] + BENCH["command"])
    assert all(_line(t) for t in texts)
    assert all(PATH.match(p) and ".." not in p for p in BENCH["paths"])
    for c in BENCH["configs"]:
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))


def test_metric_forms():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    from benchmark.run import cell_files

    files = cell_files(cell)
    entry = {w["name"]: w for w in BENCH["workloads"]}[cell]
    assert files.cell["config"] == entry["config"]
    assert files.cell["traffic"] == entry["traffic"]
    assert files.cell["why"] == entry["why"]
    assert entry["chips"] == 1
    importlib.import_module(f"benchmark.drivers.{files.traffic['step']}")
    assert files.cell["limits"]


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    with open(os.path.join(ROOT, config["file"])) as f:
        conf = json.load(f)
    assert conf["name"] == config["name"]
    assert conf["source"] == config["source"]
    assert conf["reduced"] == config["reduced"]
    assert conf["assumed"]


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_readers(metric):
    assert callable(importlib.import_module(
        f"benchmark.metrics.{metric}").read)
