"""BENCHMARK.json and the files it names: found by name, within the
contract's limits; a new file is picked up without an edit."""

import json
import re
import shutil

import pytest

from portbench.harness.spec import HOME, ROOT, Bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CHECKS = {"missing", "bad", "fit_excess", "code_excess", "dist_gap",
          "dist_mean", "sel_miss"}


@pytest.fixture(scope="module")
def spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["command"] == ["python3", "portbench/run.py"]
    assert spec["paths"] == ["portbench"]
    assert 1 <= spec["run_seconds"] <= 51
    assert len(json.dumps(spec)) < 64 * 1024


def test_names_units_and_lines(spec):
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in spec[k]]
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for x in spec["configs"] + spec["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"]
    for c in spec["configs"]:
        assert 1 <= len(c["source"]) <= 200
        assert set(c) == {"name", "source", "file", "reduced", "why"}


def test_bounds(spec):
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in spec["end_to_end"])


def test_each_cell_has_its_files_and_metrics(spec):
    bench = Bench()
    configs = {c["name"] for c in spec["configs"]}
    used = set()
    for w in spec["workloads"]:
        assert w["chips"] == 1 and w["config"] in configs
        used.add(w["config"])
        cell = bench.cell(w["name"])
        assert set(cell.limits) == CHECKS
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e
            assert callable(bench.reader(m["name"]))
    assert used == configs


def test_reduced_keys_exist_in_the_config(spec):
    for c in spec["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("portbench/")
        assert cfg["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert key in cfg and key in cfg["published"]
            assert cfg[key] != cfg["published"][key]


def test_new_files_are_found_without_an_edit(tmp_path):
    root = tmp_path / "root"
    home = root / "portbench"
    shutil.copytree(HOME, home, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "sift1m_m64.burst", "config":
                              "sift1m_m64", "traffic": "burst", "chips": 1,
                              "why": "new"})
    spec["per_layer"].append({"name": "calls_in_slice", "unit": "calls",
                              "better": "higher", "source": "program_counter",
                              "layer": "engine", "moves": "setup_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    mix = json.loads((HOME / "mixes" / "bulk.json").read_text())
    (home / "mixes" / "burst.json").write_text(json.dumps(
        {**mix, "burst": {"factor": 2.0}}))
    (home / "cells" / "sift1m_m64.burst.json").write_text(json.dumps(
        {"traffic": {"batch": 123}, "limits": {k: 0 for k in CHECKS}}))
    (home / "metrics" / "calls_in_slice.py").write_text(
        "def read(t):\n    return len(t.calls)\n")
    bench = Bench(root=root, home=home)
    cell = bench.cell("sift1m_m64.burst")
    assert cell.params["batch"] == 123 and cell.params["burst"]
    assert "calls_in_slice" in {m["name"] for m in cell.per_layer}

    class T:
        calls = [1, 2, 3]

    assert bench.reader("calls_in_slice")(T()) == 3


def test_a_qualified_metric_falls_back_to_its_kind(tmp_path):
    bench = Bench()
    assert bench.reader("device_idle.anything") is not None
    home = tmp_path / "portbench"
    shutil.copytree(HOME, home, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    (home / "metrics" / "device_idle.own.py").write_text(
        "def read(t):\n    return 7\n")
    own = Bench(root=ROOT, home=home)
    assert own.reader("device_idle.own")(None) == 7
