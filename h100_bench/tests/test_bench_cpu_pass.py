"""Each cell's entry at tiny sizes on the CPU prints the result line,
correct, with every device reading "not measured"."""

import json

import pytest

from h100_bench import harness

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cpu_pass_prints_the_last_line(cell, trace, tmp_path):
    line, out = harness.cpu_pass(cell, 2 ** 31 + 11, bool(trace),
                                 str(tmp_path))
    res = json.loads(line)
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    e2e, layer = harness.cell_metrics(cell, harness.manifest())
    assert set(res["metrics"]) == {m["name"] for m in (layer if trace
                                                       else e2e)}
    assert all(v["value"] == harness.NOT_MEASURED
               for v in res["metrics"].values())
    assert res["device"]["memory_peak_bytes"] == harness.NOT_MEASURED
    assert set(res["checks"]) == set(harness.load_json(
        harness.BENCH, "workloads", f"{cell}.json")["limits"])
