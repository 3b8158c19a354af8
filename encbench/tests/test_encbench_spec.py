"""BENCHMARK.json against the benchmark's contract, and every name in it
resolving to its file."""

import json
import re

import pytest

from encbench.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_keys_and_limits(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(bench["command"]) <= 32
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    assert 1 <= len(bench["configs"]) <= 24
    assert 1 <= len(bench["workloads"]) <= 24
    assert 1 <= len(bench["end_to_end"]) <= 16
    assert 1 <= len(bench["per_layer"]) <= 128


def test_names_and_units(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k]), w[k]
    metrics = bench["end_to_end"] + bench["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    for group in (names, [w["name"] for w in bench["workloads"]],
                  [m["name"] for m in metrics]):
        assert len(group) == len(set(group))
    texts = ([c["why"] for c in bench["configs"]]
             + [c["source"] for c in bench["configs"]]
             + [w["why"] for w in bench["workloads"]]
             + [m["layer"] for m in bench["per_layer"]] + bench["command"])
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t


def test_every_cell_resolves(bench):
    from encbench import harness

    cells = {w["name"] for w in bench["workloads"]}
    configs = {c["name"]: c for c in bench["configs"]}
    assert {w["config"] for w in bench["workloads"]} == set(configs)
    for w in bench["workloads"]:
        cfg = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
        assert cfg["name"] == w["config"]
        assert (ROOT / "encbench" / "traffic"
                / f"{w['traffic']}.json").is_file()
        for trace in (False, True):
            spec = harness.load_spec(w["name"], trace)
            assert spec.metrics
            for m in spec.metrics:
                assert callable(harness.reader(m["name"]))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for c in bench["configs"]:
        assert c["file"].startswith(bench["paths"][0] + "/")


def test_every_cell_reports_each_kind(bench):
    e2e = bench["end_to_end"]
    for w in bench["workloads"]:
        mine = [m for m in e2e if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        assert [m for m in bench["per_layer"]
                if w["name"] in m.get("workloads", [w["name"]])]
