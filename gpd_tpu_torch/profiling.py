"""Tracing and profiling hooks (port of gpd_tpu/profiling.py).

The reference's observability is per-stage wall-clock prints
(src/gpd/grasp_detector.cpp:313-320, hand_search.cpp:60-61), which
``GraspDetector.detect`` keeps. On top of that: a ``torch.profiler`` trace
of host and device activity (CUDA kernels on the card), written as a Chrome
trace (viewable in Perfetto or chrome://tracing) when the ``GPD_TPU_PROFILE``
environment variable names a directory, and named spans (``span``) at the
boundaries of a grasp request's and a training epoch's layers. A span costs
nothing without a running profiler (a shared null context, no call into
torch) and adds no device sync.

Usage:
    GPD_TPU_PROFILE=/tmp/gpd_trace python -m gpd_tpu_torch.apps.detect_grasps ...
or programmatically:
    with profiling.maybe_trace("/tmp/gpd_trace") as prof:   # no-op without
        detector.detect(cloud)                              # a directory

The spans, by where they open (one request runs at a time on one thread,
so a request's spans are those nested in its ``detect``, with the
``read_file`` and ``preprocess`` just before it):

    read_file           io.pcd.load_cloud_file: the whole parse
    preprocess          GraspDetector.preprocess_cloud, from its first line
      preprocess_upload   the raw cloud's upload (CloudArrays.from_numpy)
      prep_filter_voxel,  each program's graph replay (or eager run)
      prep_outliers,
      prep_normals
      preprocess_compact  each compact_host: its reads back and re-upload
      preprocess_capture  a program's CUDA graph capture (a new key)
    detect              GraspDetector.detect (not staged): the request
      detect_core         A, the read of its counts and B; ends in a wait
        candidates          A (the hand search), generator hand-offs included
        candidates_read     the one host read between A and B
        score               B (descriptors, images, LeNet)
        detect_capture      a part's CUDA graph capture (a new key)
      select_and_cluster  C (selection, clustering); ends in a wait
      detect_result       the read of the selection's valid flags
    train_upload        net.train.fit: a block's permutation, images, labels
    train_steps         net.train.fit: the loop over one block's steps
    train_eval          net.train.fit: each evaluate call (ends in a read)
    datagen_view        DataGenerator.generate_view: one (object, view) unit
      datagen_attempt     each attempt: detect's candidates, candidates_read
                          and score (B with images), then
        relabel             R's replay (or eager run) and the labels' read
      datagen_rows        the balance, the gathers, the kept rows' copy
    cem_detect          SequentialImportanceSampling.detect: a CEM request
      cem_program         the fused route: R, S and the read (replays on a
                          card, eager runs on the CPU)
        cem_rounds          R (the rounds)
        cem_scoring         S (scoring, selection) and the read
          cem_capture         in either, a new key's warm-up and capture
      cem_rounds,         the loop's (``_force_loop``, ``mesh=``) phases
      cem_scoring,
      select_and_cluster

``StageTimer.stage`` opens a span of its stage's name too.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch
from torch.autograd import profiler as _autograd_profiler


def profile_dir() -> Optional[str]:
    d = os.environ.get("GPD_TPU_PROFILE", "")
    return d or None


@contextlib.contextmanager
def maybe_trace(trace_dir: Optional[str] = None) -> Iterator[
        Optional[torch.profiler.profile]]:
    """Wrap a block in a ``torch.profiler`` trace of the CPU and, where
    there is one, the CUDA device, if ``trace_dir`` or GPD_TPU_PROFILE names
    a directory; yields the profiler, whose Chrome trace is written into the
    directory at exit. Otherwise a no-op that yields None. Inside another
    trace it traces nothing of its own (the outer one records the block)."""
    d = trace_dir or profile_dir()
    if not d or _autograd_profiler._is_profiler_enabled:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    print(f"# torch profiler trace written to {path}")


# What ``span`` returns while no profiler runs: one shared, reusable null
# context.
_OFF = contextlib.nullcontext()


def span(name: str):
    """Named span: while a profiler runs, ``torch.profiler.record_function``,
    a host range in the trace around the work queued inside it; otherwise
    the shared null context, with no call into torch. So a span opened
    before a profiler starts records nothing: open spans inside
    ``maybe_trace``."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


class StageTimer:
    """Per-stage wall-clock times of one request, in the reference's
    RUNTIMES format (grasp_detector.cpp:313-320). Device work is
    asynchronous, so the timer waits for ``device`` (when it is a CUDA
    device) at the end of each stage: a stage's time then covers the device
    work it queued. A stage is a block (``stage``) or the time since the
    previous ``mark``; either adds to the stage's total, so chunked stages
    sum over their chunks. With ``on=False`` nothing waits and nothing is
    recorded."""

    def __init__(self, device: Optional[torch.device] = None,
                 on: bool = True):
        self.device = device
        self.on = on
        self.stages = {}
        self._t0 = self._last = time.perf_counter()

    def _add(self, name: str, since: float) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.stages[name] = self.stages.get(name, 0.0) + now - since
        self._last = now

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t = time.perf_counter()
        with span(name):
            yield
        if self.on:
            self._add(name, t)

    def mark(self, name: str) -> None:
        if self.on:
            self._add(name, self._last)

    def total(self) -> float:
        return time.perf_counter() - self._t0

    def report(self) -> str:
        lines = ["======== RUNTIMES ========"]
        for i, (name, dt) in enumerate(self.stages.items(), 1):
            lines.append(f" {i}. {name}: {dt:.4f}s")
        lines.append("==========")
        lines.append(f" TOTAL: {self.total():.4f}s")
        return "\n".join(lines)
