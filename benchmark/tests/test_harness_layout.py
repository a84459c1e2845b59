"""BENCHMARK.json against the benchmark's contract, and the harness
finding a new cell's files by name with no edit."""

import json
import re
import shutil

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_top_level(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(bench["command"]) <= 32
    for word in bench["command"]:
        assert LINE.match(word) and not word.startswith("/")
        assert ".." not in word
    assert (ROOT / bench["command"][1]).is_file()
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(bench, section):
    names = [e["name"] for e in bench[section]]
    assert len(names) == len(set(names))
    for e in bench[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") \
            else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"])
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")
        for key in ("why", "layer", "source"):
            if key in e and section != "end_to_end":
                assert LINE.match(e[key]), (e["name"], key)


def test_configs_and_cells(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    for c in configs.values():
        assert c["file"].startswith("benchmark/")
        assert (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key)
            assert not re.search(r"(_dim|_rank|hidden|width|latent)$", key)
        assert any(w["config"] == c["name"] for w in bench["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in bench["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"])
        for d in ("traffic", "limits"):
            name = w["traffic"] if d == "traffic" else w["name"]
            assert (ROOT / "benchmark" / d / f"{name}.json").is_file()
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(
        1, len(bench["workloads"]) // 4)


def test_metrics(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25

    def reported(m):
        return set(m.get("workloads", cells))

    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert reported(m) <= cells
    layers = {}
    for m in bench["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        # the metric it moves is reported by every cell it lists
        assert reported(m) <= reported(e2e[m["moves"]]), m["name"]
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
        layers.setdefault(m["layer"], set()).add(m["name"])
    for cell in cells:
        assert "setup_s" in {m for m in e2e if cell in reported(e2e[m])}
        assert len([m for m in e2e if cell in reported(e2e[m])]) >= 2
        assert any(cell in reported(m) for m in bench["per_layer"])


def test_new_files_found_by_name(tmp_path):
    """A cell added as new files and entries only is found and loaded."""
    from benchmark import harness

    here = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", here,
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    cfg = json.loads((here / "configs" / "nerf_yolo.json").read_text())
    (here / "configs" / "new_model.json").write_text(json.dumps(cfg))
    traffic = json.loads((here / "traffic" / "yolo_detect.json").read_text())
    traffic["ns"] = 2
    (here / "traffic" / "new_mix.json").write_text(json.dumps(traffic))
    (here / "limits" / "new_cell.json").write_text(
        (here / "limits" / "yolo_detect.json").read_text())
    (here / "metrics" / "new_metric.py").write_text(
        "def read(sl):\n    return 42.0\n")
    bench["configs"].append({"name": "new_model", "source": "x",
                             "file": "benchmark/configs/new_model.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "new_cell", "config": "new_model",
                               "traffic": "new_mix", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "new_metric", "unit": "ms",
                               "better": "lower", "source": "device_trace",
                               "layer": "x", "moves": "view_p95_ms",
                               "workloads": ["new_cell"]})
    for m in bench["end_to_end"]:
        if m["name"] == "view_p95_ms":
            m["workloads"].append("new_cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell("new_cell", root=tmp_path)
    assert cell.traffic["ns"] == 2 and cell.here == here
    assert [m["name"] for m in cell.per_layer] == ["new_metric"]
    assert {m["name"] for m in cell.end_to_end} == {"view_p95_ms",
                                                    "setup_s"}
    assert harness.load_module(here / "metrics" / "new_metric.py").read(
        None) == 42.0
