"""The data-generation cell (``gpd15_datagen.zoo_views``): its configuration
builds the program's DataGenConfig; a run whose data generation is broken
underneath comes out not correct (at tiny sizes on the CPU, as
``test_bench_faults`` drives the other cells); the tiny pass's kept rows
come back to the host as the rows the program returned; and its readers,
on a made-up trace of two views whose spans, device operations and
counters are known, read the values worked out by hand, and nothing where
the program's spans or counters are absent (an older program), where no
device work was traced (a CPU run) or where there are no events."""

import json
import os

import numpy as np
import pytest

from h100_bench import harness

CELL = "gpd15_datagen.zoo_views"


def test_datagen_block_builds_the_program_config():
    from gpd_tpu_torch.datagen import DataGenConfig
    body = harness.load_json(harness.BENCH, "configs", "gpd15_datagen.json")
    mix = harness.load_json(harness.BENCH, "traffic", "zoo_views.json")
    cfg = DataGenConfig(**body["datagen"])
    assert cfg.num_samples == body["detector"]["num_samples"] == 500
    assert (cfg.min_grasps_per_view, cfg.max_grasps_per_view) == (100, 500)
    assert cfg.num_views_per_object == mix["views_per_object"]
    DataGenConfig(**{**body["datagen"], **mix["tiny"]["datagen"]})
    gpd15 = harness.load_json(harness.BENCH, "configs", "gpd15.json")
    assert {k: v for k, v in body["detector"].items()
            if k != "num_samples"} == {k: v for k, v in
                                       gpd15["detector"].items()
                                       if k != "num_samples"}
    man = {c["name"]: c for c in harness.manifest()["configs"]}
    assert man["gpd15_datagen"]["reduced"] == body["reduced"]


# ------------------------------------------------------------------ faults

def view_labels(monkeypatch):
    """Every candidate relabelled against the view cloud."""
    from gpd_tpu_torch import datagen
    real = datagen.DataGenerator._attempt
    monkeypatch.setattr(datagen.DataGenerator, "_attempt",
                        lambda self, view, mesh, *a: real(self, view, view,
                                                          *a))


def stale_images(monkeypatch):
    """Every attempt's rows given the images of the attempt before it (a
    view's first attempt those of the view before)."""
    import torch
    from gpd_tpu_torch import datagen
    real = datagen.DataGenerator._attempt
    last = []

    def attempt(self, *a):
        labels, images, hands = real(self, *a)
        last.append(images)
        old = last[-2] if len(last) > 1 else images
        return labels, old[torch.arange(len(images)) % len(old)], hands
    monkeypatch.setattr(datagen.DataGenerator, "_attempt", attempt)


@pytest.mark.parametrize("fault", [view_labels, stale_images],
                         ids=lambda f: f.__name__)
def test_fault_is_not_correct(fault, monkeypatch, tmp_path):
    fault(monkeypatch)
    line, _ = harness.cpu_pass(CELL, 2 ** 31 + 3, False, str(tmp_path))
    res = json.loads(line)
    assert res["correct"] is False, res["checks"]


def test_kept_rows_round_trip(tmp_path):
    """A tiny unit's capture holds the program's returned rows: each kept
    row's label and image is the one ``generate_view`` returned, and its
    hand is one of the unit's candidates."""
    import torch
    from gpd_tpu_torch.datagen import DataGenConfig, DataGenerator
    from gpd_tpu_torch.detector import GraspDetector
    entry = harness.load_module(
        os.path.join(harness.BENCH, "entries", "datagen.py"),
        "h100_bench_entry_datagen")
    r = harness.cell_run(CELL, 1, 1.0, False, "cpu", 0.0, str(tmp_path),
                         tiny=True)
    det = GraspDetector(entry.serve.program_config(
        r.config["detector"], r.path(r.config["weights"])), device="cpu")
    gen = DataGenerator(det, DataGenConfig(**entry.datagen_spec(r)))
    pool = entry.Pool(r, det, gen)
    images, labels, view = pool.request(0)
    outs = entry.capture(gen, pool, 0, images, view)
    assert torch.is_tensor(gen.last_rows["label"]) and len(labels) > 0
    np.testing.assert_array_equal(outs.rows["label"], labels)
    np.testing.assert_array_equal(outs.images, images)
    assert outs.attempts == gen.last_counts["attempts"] >= 1
    assert len(labels) == gen.last_counts["kept"]
    fields = ("sample", "orientation", "top", "finger_placement",
              "sample_id", "attempt", "label")

    def rows(hands):
        flat = np.concatenate([np.asarray(hands[k], np.float64).reshape(
            len(hands["label"]), -1) for k in fields], 1)
        return {tuple(x) for x in flat}
    assert rows(outs.rows) <= rows(outs.candidates)


# ----------------------------------------------------------------- readers

WINDOW = (0.0, 1000.0)


def span(name, a, b):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": a,
            "dur": b - a}


def call(name, t, corr):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": t,
            "dur": 1.0, "args": {"correlation": corr}}


def op(cat, a, b, corr, name=None):
    return {"ph": "X", "cat": cat, "name": name or f"{cat}_{corr}",
            "ts": a, "dur": b - a, "args": {"correlation": corr}}


def view(t, c):
    """One unit from ``t`` (microseconds): preprocess [0, 50] with a kernel
    of 20; datagen_view [60, 400] holding one attempt [60, 300]:
    candidates [60, 80] launching A's graph (a kernel of 40, 80 to 120),
    candidates_read [120, 130] (a copy of 2 to the host), score [130,
    150] launching B's graph (kernels of 50 and 30, 150 to 230), relabel
    [230, 300] launching R's graph (a kernel of 40, 235 to 275) and the
    labels' read (a copy of 3, 280 to 283); then datagen_rows [300, 400]
    with the rows' images copied to the host (50, 320 to 370) and a
    host-to-device copy of the row indices (1, 310 to 311)."""
    d2h, h2d = "Memcpy DtoH (Device -> Pageable)", "Memcpy HtoD"
    return [
        span("preprocess", t, t + 50),
        call("cudaLaunchKernel", t + 5, c), op("kernel", t + 10, t + 30, c),
        span("datagen_view", t + 60, t + 400),
        span("datagen_attempt", t + 60, t + 300),
        span("candidates", t + 60, t + 80),
        call("cudaGraphLaunch", t + 70, c + 1),
        op("kernel", t + 80, t + 120, c + 1),
        span("candidates_read", t + 120, t + 130),
        call("cudaMemcpyAsync", t + 121, c + 2),
        op("gpu_memcpy", t + 122, t + 124, c + 2, d2h),
        span("score", t + 130, t + 150),
        call("cudaGraphLaunch", t + 135, c + 3),
        op("kernel", t + 150, t + 200, c + 3),
        op("kernel", t + 200, t + 230, c + 3),
        span("relabel", t + 230, t + 300),
        call("cudaGraphLaunch", t + 232, c + 4),
        op("kernel", t + 235, t + 275, c + 4),
        call("cudaMemcpyAsync", t + 279, c + 5),
        op("gpu_memcpy", t + 280, t + 283, c + 5, d2h),
        span("datagen_rows", t + 300, t + 400),
        call("cudaMemcpyAsync", t + 305, c + 6),
        op("gpu_memcpy", t + 310, t + 311, c + 6, h2d),
        call("cudaMemcpyAsync", t + 315, c + 7),
        op("gpu_memcpy", t + 320, t + 370, c + 7, d2h),
    ]


def events():
    """Two units, at 0 and 500. Inside datagen_view the device is busy over
    [80, 120], [122, 124], [150, 230], [235, 275], [280, 283], [310, 311],
    [320, 370]: 216 of its 340 us, idle 124."""
    return [span("bench_window", *WINDOW)] + view(0.0, 1) + view(500.0, 11)


COUNTERS = [dict(latency_s=0.1, attempts=1, candidates=900, positives=150,
                 kept=300, mesh_points=6000),
            dict(latency_s=0.2, attempts=2, candidates=1800, positives=200,
                 kept=400, mesh_points=6000)]
EXPECTED = {
    # A's 40 and B's 50 + 30 us a view, the read outside both spans.
    "datagen_images_kernel_ms": 0.120,
    # R's 40 and the labels' read, 3 us.
    "datagen_relabel_kernel_ms": 0.043,
    "datagen_idle_ms": 0.124,
    # 2 + 3 + 50 us a view.
    "d2h_copy_ms.datagen": 0.055,
    "datagen_attempts_per_view": 1.5,
}
NEW_SPANS = {"datagen_view", "datagen_attempt", "relabel", "datagen_rows"}


def reader(name):
    return harness.load_module(
        os.path.join(harness.BENCH, "metrics", f"{name}.py"),
        "h100_bench_metric_" + name.replace(".", "_"))


def layer_of(evs, counters=COUNTERS):
    return dict(events=evs, window=WINDOW, views=counters)


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
        counters = [{k: v for k, v in q.items()
                     if k not in ("kept", "mesh_points")} for q in COUNTERS]
    elif case == "no device work":
        evs = [e for e in evs if e["cat"] == "user_annotation"]
    else:
        evs = []
    assert reader(name).read(layer_of(evs, counters)) is None
