"""The CEM cell (``gpd15_cem.cem_table_stream``): its configuration builds
the program's CEMConfig; a run whose CEM is broken underneath comes out
not correct (at tiny sizes on the CPU, as ``test_bench_faults`` drives the
other cells); and its readers, on a made-up trace of two CEM requests whose
spans, launches, device operations and counters are known, read the
values worked out by hand, and nothing where the program's spans or
counters are absent (an older program), where no device work was traced
(a CPU run) or where there are no events."""

import dataclasses
import json
import os

import pytest

from h100_bench import harness

CELL = "gpd15_cem.cem_table_stream"


def test_cem_block_builds_the_program_config():
    from gpd_tpu_torch.config import CEMConfig
    body = harness.load_json(harness.BENCH, "configs", "gpd15_cem.json")
    assert CEMConfig(**body["cem"]) == CEMConfig()     # upstream's defaults
    tiny = harness.load_json(harness.BENCH, "traffic",
                             "cem_table_stream.json")["tiny"]["cem"]
    CEMConfig(**{**body["cem"], **tiny})
    gpd15 = harness.load_json(harness.BENCH, "configs", "gpd15.json")
    assert body["detector"] == gpd15["detector"]


# ------------------------------------------------------------------ faults

def centres_from_invalid_slots(monkeypatch):
    """Every filled slot of the earlier rounds a mixture centre, valid or
    not."""
    from gpd_tpu_torch.ops import draws
    real = draws.cem_round
    monkeypatch.setattr(draws, "cem_round", lambda g, c, m, *a: real(
        g, c, (c != 0).any(1), *a))


def uniform_draws_first(monkeypatch):
    """A round's uniform draws put before its mixture draws."""
    from gpd_tpu_torch.ops import draws
    real = draws.cem_round

    def swapped(g, c, m, points, pm, sigma, ws, method, n_gauss, n_rand):
        s = real(g, c, m, points, pm, sigma, ws, method, n_gauss, n_rand)
        return s.roll(n_rand, 0)
    monkeypatch.setattr(draws, "cem_round", swapped)


def prune_skipped(monkeypatch):
    """The selection made from every scored hand, the prune at min_score
    left out."""
    from gpd_tpu_torch import cem
    real = cem._cem_scoring
    monkeypatch.setattr(cem, "_cem_scoring", lambda *a: real(
        *a[:6], -float("inf"), *a[7:]))


def scores_on_other_hands(monkeypatch):
    """Round 1's hands scored with round 0's scores, slot for slot."""
    import torch
    from gpd_tpu_torch import cem
    real = cem._merge

    def merge(scored):
        a, b = scored[0], scored[1]
        moved = torch.where(b.valid, torch.nan_to_num(a.score, neginf=0.0),
                            -torch.inf)
        return real([a, dataclasses.replace(b, score=moved), *scored[2:]])
    monkeypatch.setattr(cem, "_merge", merge)


# Every seed checks the tiny pool's first scene (scene 101: with a pool of
# two, the first place of the first pass is always entry 0), whose round 0
# leaves samples without a valid hand far from every valid one, where
# drawing about them shows.
@pytest.mark.parametrize("fault", [
    centres_from_invalid_slots, uniform_draws_first, prune_skipped,
    scores_on_other_hands], ids=lambda f: f.__name__)
def test_fault_is_not_correct(fault, monkeypatch, tmp_path):
    fault(monkeypatch)
    line, _ = harness.cpu_pass(CELL, 2 ** 31 + 3, False, str(tmp_path))
    res = json.loads(line)
    assert res["correct"] is False, res["checks"]


# ----------------------------------------------------------------- readers

WINDOW = (0.0, 1000.0)


def span(name, a, b):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": a,
            "dur": b - a}


def call(name, t, corr):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": t,
            "dur": 1.0, "args": {"correlation": corr}}


def op(cat, a, b, corr):
    return {"ph": "X", "cat": cat, "name": f"{cat}_{corr}", "ts": a,
            "dur": b - a, "args": {"correlation": corr}}


def request(t, c):
    """One CEM request from ``t`` (microseconds): preprocess [0, 100] with
    a kernel of 40; cem_detect [110, 400] holding cem_program [120, 390]:
    cem_rounds [120, 150] launching R's graph (kernels of 60 and 40, from
    150 to 250) and two fills (1 each), cem_scoring [150, 390] launching
    S's graph (kernels 100 and 20, 255 to 375), and the read (a copy of 5
    at 380)."""
    return [
        span("preprocess", t, t + 100),
        call("cudaLaunchKernel", t + 10, c), op("kernel", t + 20, t + 60, c),
        span("cem_detect", t + 110, t + 400),
        span("cem_program", t + 120, t + 390),
        span("cem_rounds", t + 120, t + 150),
        call("cudaLaunchKernel", t + 125, c + 1),
        op("kernel", t + 126, t + 127, c + 1),
        call("cudaLaunchKernel", t + 128, c + 2),
        op("kernel", t + 129, t + 130, c + 2),
        call("cudaGraphLaunch", t + 140, c + 3),
        op("kernel", t + 150, t + 210, c + 3),
        op("kernel", t + 210, t + 250, c + 3),
        span("cem_scoring", t + 150, t + 390),
        call("cudaGraphLaunch", t + 155, c + 4),
        op("kernel", t + 255, t + 355, c + 4),
        op("kernel", t + 355, t + 375, c + 4),
        call("cudaMemcpyAsync", t + 376, c + 5),
        op("gpu_memcpy", t + 380, t + 385, c + 5),
    ]


def events():
    """Two requests, at 0 and 500. The device is busy in cem_detect over
    [126, 127], [129, 130], [150, 250], [255, 375], [380, 385]: idle 16 +
    2 + 20 + 5 + 5 + 15 = 63 us of its 290 per request."""
    return [span("bench_window", *WINDOW)] + request(0.0, 1) + \
        request(500.0, 11)


COUNTERS = [dict(latency_s=0.04, live_hands=600, image_slots=3072),
            dict(latency_s=0.06, live_hands=450, image_slots=3072)]
EXPECTED = {
    # 1 + 1 + 60 + 40 us a request.
    "cem_rounds_kernel_ms": 0.102,
    # 100 + 20 + 5 us a request.
    "cem_scoring_kernel_ms": 0.125,
    "cem_idle_ms": 0.063,
    "cem_live_image_share": 1050 / 6144 * 100,
    # 1050 hands of 83.042 MFLOP over 0.1 s at 989 TFLOP/s.
    "cem_request_mfu": 1050 * 83_042_000 / 0.1 / 989e12 * 100,
}
NEW_SPANS = {"cem_detect", "cem_rounds", "cem_scoring"}


def reader(name):
    return harness.load_module(
        os.path.join(harness.BENCH, "metrics", f"{name}.py"),
        "h100_bench_metric_" + name)


def layer_of(evs, counters=COUNTERS):
    return dict(events=evs, window=WINDOW, preprocess_s=[0.1, 0.1],
                channels=15, size=60, cem_requests=counters)


def test_every_reader_of_the_cell_is_read_here():
    names = {m["name"] for m in harness.manifest()["per_layer"]
             if CELL in m.get("workloads", [])}
    assert names == set(EXPECTED)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_the_known_value(name):
    got = reader(name).read(layer_of(events()))
    assert got == pytest.approx(EXPECTED[name], rel=1e-9)


@pytest.mark.parametrize("case", ["older program", "no device work",
                                  "no events"])
@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_finds_nothing_without_its_input(name, case):
    evs, counters = events(), COUNTERS
    if case == "older program":
        evs = [e for e in evs if e["name"] not in NEW_SPANS]
        counters = [dict(latency_s=q["latency_s"]) for q in COUNTERS]
    elif case == "no device work":
        evs = [e for e in evs if e["cat"] == "user_annotation"]
    else:
        evs = []
    assert reader(name).read(layer_of(evs, counters)) is None
