"""BENCHMARK.json against the benchmark's files and the manifest's shape:
every entry resolves to its files by name."""

import json
import os
import re

import pytest

from h100_bench import harness

MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MAN["workloads"]]


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["h100_bench"]
    assert MAN["command"] == ["python3", "h100_bench/run.py"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    spec = {w["name"]: w for w in MAN["workloads"]}[cell]
    assert set(spec) == {"name", "config", "traffic", "chips", "why"}
    assert spec["chips"] == 1 and 1 <= len(spec["why"]) <= 200
    w = harness.load_json(harness.BENCH, "workloads", f"{cell}.json")
    assert (w["config"], w["traffic"]) == (spec["config"], spec["traffic"])
    for rel in (f"configs/{w['config']}.json", f"traffic/{w['traffic']}.json",
                f"entries/{w['entry']}.py"):
        assert os.path.exists(os.path.join(harness.BENCH, rel)), rel
    assert w["limits"] and w["controls"]
    e2e, layer = harness.cell_metrics(cell, MAN)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layer


@pytest.mark.parametrize("cfg", MAN["configs"], ids=lambda c: c["name"])
def test_config_resolves(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert cfg["file"].startswith("h100_bench/configs/")
    body = harness.load_json(harness.ROOT, cfg["file"])
    assert body["source"] == cfg["source"]
    assert body["reduced"] == cfg["reduced"] == []
    assert os.path.exists(os.path.join(harness.ROOT, body["weights"]))
    from h100_bench.entries import serve
    serve.program_config(body["detector"], "")    # every key known
    assert any(w["config"] == cfg["name"] for w in MAN["workloads"])


@pytest.mark.parametrize("m", MAN["end_to_end"] + MAN["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_shape(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    if m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in MAN["end_to_end"]}
        assert os.path.exists(os.path.join(harness.BENCH, "metrics",
                                           f"{m['name']}.py"))
        for cell in m["workloads"]:
            e2e, _ = harness.cell_metrics(cell, MAN)
            assert m["moves"] in {e["name"] for e in e2e}


def test_names_unique_and_valid():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in MAN[group]]
        assert len(names) == len(set(names)) and all(map(NAME.match, names))
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    json.dumps(MAN)
