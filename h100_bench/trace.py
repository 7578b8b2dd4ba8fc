"""Reading a ``torch.profiler`` trace of a traced window: device activity,
busy and idle time, the breakdown, and kernels by the host span that
launched them (by the correlation id of their launch call; a CUDA graph's
kernels carry its one ``cudaGraphLaunch``'s)."""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "bench_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def profiler() -> torch.profiler.profile:
    return torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])


def span(name: str):
    """A host span the trace records (``record_function``)."""
    return torch.profiler.record_function(name)


def events(prof, tmp: str) -> List[dict]:
    """The trace's events, through a Chrome trace file in ``tmp`` that is
    deleted after reading."""
    path = os.path.join(tmp, "trace.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def spans(evs: List[dict], name: str) -> List[dict]:
    return sorted((e for e in evs if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation"
                   and e.get("name") == name), key=lambda e: e["ts"])


def window(evs: List[dict]) -> Tuple[float, float]:
    """(start, end) in microseconds of the ``bench_window`` span."""
    (w,) = spans(evs, WINDOW)
    return w["ts"], w["ts"] + w["dur"]


def device_ops(evs: List[dict], cats=DEVICE_CATS) -> List[dict]:
    return [e for e in evs if e.get("ph") == "X" and e.get("cat") in cats]


def clipped(ops: List[dict], w0: float, w1: float) -> List[Tuple[float, float, dict]]:
    out = []
    for e in ops:
        a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if b > a:
            out.append((a, b, e))
    return sorted(out, key=lambda t: t[0])


def busy_and_gaps(evs: List[dict], w0: float, w1: float):
    """(busy microseconds, [(gap start, gap end)]) of the device over the
    window: the union of its kernels, copies and sets."""
    busy, end, gaps = 0.0, w0, []
    for a, b, _ in clipped(device_ops(evs), w0, w1):
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if w1 > end:
        gaps.append((end, w1))
    return busy, gaps


def launch_times(evs: List[dict]) -> Dict[int, Tuple[float, str]]:
    """Correlation id -> (host launch time, runtime call name)."""
    return {e["args"]["correlation"]: (e["ts"], e["name"]) for e in evs
            if e.get("cat") == "cuda_runtime"
            and "correlation" in e.get("args", {})}


def launched_inside(evs: List[dict], intervals, cats=("kernel",)
                    ) -> List[dict]:
    """Device operations whose host launch lies inside any of
    ``intervals`` [(start, end)] (microseconds)."""
    launch = launch_times(evs)
    out = []
    for e in device_ops(evs, cats):
        t = launch.get(e.get("args", {}).get("correlation"))
        if t is not None and any(a <= t[0] <= b for a, b in intervals):
            out.append(e)
    return out


def _host_label(evs: List[dict], t: float) -> str:
    """What the host was doing at ``t``: the innermost benchmark or program
    span, else the innermost operator or runtime call, else "host"."""
    best: Optional[dict] = None
    for e in evs:
        if (e.get("ph") == "X" and e.get("cat") in
                ("user_annotation", "cpu_op", "cuda_runtime")
                and e["ts"] <= t <= e["ts"] + e["dur"]
                and e.get("name") != WINDOW):
            if best is None or e["dur"] < best["dur"]:
                best = e
    return best["name"][:80] if best else "host"


def breakdown(evs: List[dict], w0: float, w1: float, top: int = 10) -> dict:
    """The device operations with the most time (seconds, summed by name)
    and the idle gaps' seconds summed by what the host was doing over
    them (the longest ``top`` gaps labelled at their midpoints)."""
    by_name: Dict[str, float] = {}
    for a, b, e in clipped(device_ops(evs), w0, w1):
        by_name[e["name"][:120]] = by_name.get(e["name"][:120], 0.0) + (b - a)
    _, gaps = busy_and_gaps(evs, w0, w1)
    by_label: Dict[str, float] = {}
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        label = _host_label(evs, (a + b) / 2)
        by_label[label] = by_label.get(label, 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(by_label.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, t / 1e6] for n, t in ops],
            "idle_gaps": [[n, t / 1e6] for n, t in idle]}


def summary(evs: List[dict]) -> dict:
    """The window's device busy seconds, length and breakdown, and the
    events for the readers."""
    w0, w1 = window(evs)
    busy, _ = busy_and_gaps(evs, w0, w1)
    return dict(busy_s=busy / 1e6, window_s=(w1 - w0) / 1e6,
                breakdown=breakdown(evs, w0, w1), window=(w0, w1))
