"""candidates_kernel_ms: the device time per request of the kernels run by
the first CUDA graph launch inside each ``detect_core`` span, program A
(samples, frames, the hand search), tied to the launch by the profiler's
correlation ids. Nothing when a request launches no graph there."""

from h100_bench import trace as tr


def read(layer):
    evs = layer.get("events")
    if not evs:
        return None
    launch = tr.launch_times(evs)
    firsts = []
    for sp in tr.spans(evs, "detect_core"):
        a, b = sp["ts"], sp["ts"] + sp["dur"]
        calls = sorted((t, c) for c, (t, name) in launch.items()
                       if name.startswith("cudaGraphLaunch") and a <= t <= b)
        if calls:
            firsts.append(calls[0][1])
    if not firsts:
        return None
    want = set(firsts)
    total = sum(e["dur"] for e in tr.device_ops(evs, ("kernel",))
                if e.get("args", {}).get("correlation") in want)
    return total / len(firsts) / 1e3
