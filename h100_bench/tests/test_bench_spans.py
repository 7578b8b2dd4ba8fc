"""The ``program_span`` readers on made-up traces: two serving requests and
a training epoch whose spans, launches, device operations and idle gaps
are known, so each reader's value is worked out by hand; and nothing read
where the program's spans are absent (an older program), where no device
work was traced (a CPU run) or where there are no events."""

import os

import pytest

from h100_bench import harness

WINDOW = (0.0, 1000.0)


def span(name, a, b, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": a, "dur": b - a}


def call(name, t, corr):
    """A runtime call at ``t`` with the correlation id ``corr``."""
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": t,
            "dur": 1.0, "args": {"correlation": corr}}


def op(cat, a, b, corr):
    return {"ph": "X", "cat": cat, "name": f"{cat}_{corr}", "ts": a,
            "dur": b - a, "args": {"correlation": corr}}


def request(t, c):
    """One request from ``t`` (microseconds), correlation ids from ``c``:
    read_file [10, 30]; preprocess [30, 100] launching a copy (10 us), a
    graph of two kernels (20 + 10) and a set (2); detect [110, 300] with
    A's graph (60), the read (a copy of 1), score [200, 250] launching B's
    graph of two kernels (35 + 30, the second past the span's end) and a
    kernel of C (10). Seven launches; a sync that launches nothing."""
    return [
        span("read_file", t + 10, t + 30),
        span("preprocess", t + 30, t + 100),
        call("cudaMemcpyAsync", t + 35, c),
        op("gpu_memcpy", t + 40, t + 50, c),
        call("cudaGraphLaunch", t + 60, c + 1),
        op("kernel", t + 60, t + 80, c + 1),
        op("kernel", t + 80, t + 90, c + 1),
        call("cudaMemsetAsync", t + 92, c + 2),
        op("gpu_memset", t + 92, t + 94, c + 2),
        span("detect", t + 110, t + 300),
        span("detect_core", t + 115, t + 260),
        call("cudaGraphLaunch", t + 120, c + 3),
        op("kernel", t + 120, t + 180, c + 3),
        call("cudaMemcpyAsync", t + 182, c + 4),
        op("gpu_memcpy", t + 185, t + 186, c + 4),
        call("cudaStreamSynchronize", t + 186, c + 5),
        span("score", t + 200, t + 250),
        call("cudaGraphLaunch", t + 205, c + 6),
        op("kernel", t + 205, t + 240, c + 6),
        op("kernel", t + 240, t + 270, c + 6),
        call("cudaLaunchKernel", t + 280, c + 7),
        op("kernel", t + 280, t + 290, c + 7),
    ]


def serving_events():
    """Two requests at 0 and 500, and work outside every program span: a
    kernel [400, 420] and a copy [450, 455]. The device's gaps in the window
    are then [0, 40], [50, 60], [90, 92], [94, 120], [180, 185],
    [186, 205], [270, 280], [290, 400], [420, 450], [455, 540] and the
    second request's, shifted by 500, to [790, 1000]."""
    return ([span("bench_window", *WINDOW)] + request(0.0, 1)
            + request(500.0, 11)
            + [call("cudaLaunchKernel", 400, 30), op("kernel", 400, 420, 30),
               call("cudaMemcpyAsync", 449, 31),
               op("gpu_memcpy", 450, 455, 31)])


def training_events():
    """An epoch of two blocks: uploads [0, 100] (copies of 50 and 20 us)
    and [500, 550] (30), steps [100, 400] (a kernel and a copy of their
    own), evaluations [400, 480] and [900, 960] (a copy of its own)."""
    return [span("bench_window", *WINDOW),
            span("train_upload", 0, 100),
            call("cudaMemcpyAsync", 10, 1), op("gpu_memcpy", 10, 60, 1),
            call("cudaMemcpyAsync", 70, 2), op("gpu_memcpy", 70, 90, 2),
            span("train_steps", 100, 400),
            call("cudaGraphLaunch", 110, 3), op("kernel", 110, 300, 3),
            call("cudaMemcpyAsync", 300, 4), op("gpu_memcpy", 300, 305, 4),
            span("train_eval", 400, 480),
            call("cudaMemcpyAsync", 410, 5), op("gpu_memcpy", 410, 420, 5),
            span("train_upload", 500, 550),
            call("cudaMemcpyAsync", 505, 6), op("gpu_memcpy", 505, 535, 6),
            span("train_steps", 550, 900),
            span("train_eval", 900, 960)]


SERVING = {
    # 10 + 20 + 10 + 2 us a request.
    "preprocess_kernel_ms": 0.042,
    # Gaps in [10, 100]: [10, 40], [50, 60], [90, 92], [94, 100].
    "preprocess_idle_ms": 0.048,
    # 35 + 30 us, the second kernel ending past the span.
    "score_kernel_ms": 0.065,
    # Gaps in [110, 300]: [110, 120], [180, 185], [186, 205], [270, 280],
    # [290, 300].
    "detect_idle_ms": 0.054,
    "launches_per_request": 7.0,
}
TRAINING = {
    # (50 + 20 + 30) us over 10 steps.
    "train_upload_ms": 0.010,
    # (80 + 60) us over 10 steps.
    "train_eval_ms": 0.014,
}
# The spans a program without these readers' spans lacks: it has
# ``preprocess`` and ``detect_core`` alone.
NEW_SPANS = {"read_file", "detect", "score", "train_upload", "train_steps",
             "train_eval"}


def reader(name):
    return harness.load_module(
        os.path.join(harness.BENCH, "metrics", f"{name}.py"),
        "h100_bench_metric_" + name)


def layer_of(name, events):
    if name in TRAINING:
        return dict(events=events, window=WINDOW, steps=10,
                    steps_spanned=10, images=640, channels=15, size=60)
    return dict(events=events, window=WINDOW, preprocess_s=[0.1, 0.1],
                channels=15, size=60)


def events_of(name):
    return training_events() if name in TRAINING else serving_events()


@pytest.mark.parametrize("name", sorted({**SERVING, **TRAINING}))
def test_reader_reads_the_known_value(name):
    want = {**SERVING, **TRAINING}[name]
    got = reader(name).read(layer_of(name, events_of(name)))
    assert got == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("case", ["older program", "no device work",
                                  "no events"])
@pytest.mark.parametrize("name", sorted({**SERVING, **TRAINING}))
def test_reader_finds_nothing_without_its_spans(name, case):
    evs = events_of(name)
    if case == "older program":
        evs = [e for e in evs if e["name"] not in NEW_SPANS]
    elif case == "no device work":
        evs = [e for e in evs if e["cat"] == "user_annotation"]
    else:
        evs = []
    assert reader(name).read(layer_of(name, evs)) is None


def test_every_program_span_metric_is_read_here():
    names = {m["name"] for m in harness.manifest()["per_layer"]
             if m["source"] == "program_span" and m["name"] != "select_ms"}
    assert names == set(SERVING) | set(TRAINING)
