"""The program's own spans in a traced window (``gpd_tpu_torch.profiling``),
for the ``program_span`` readers: the merged host intervals of named spans,
the device's idle time inside them, and the device work and runtime calls
launched inside them. A reader divides by the window's ``detect`` spans
(one a request: the detector serves one request at a time) or by its
steps, and finds nothing in a trace without the spans it reads or
without device work."""

from typing import List, Optional, Sequence, Tuple

from h100_bench import trace as tr

# CUDA runtime calls, and the low-level `cu*` launch, that put work on the
# card.
LAUNCHES = ("cudaLaunchKernel", "cudaGraphLaunch", "cudaMemcpy",
            "cudaMemset", "cuLaunchKernel")


def intervals(layer, names: Sequence[str]) -> List[Tuple[float, float]]:
    """The union of the window's spans named in ``names``, clipped to the
    window, as sorted disjoint (start, end) microseconds."""
    w0, w1 = layer["window"]
    ivs = sorted((max(e["ts"], w0), min(e["ts"] + e["dur"], w1))
                 for n in names for e in tr.spans(layer["events"], n))
    out: List[List[float]] = []
    for a, b in ivs:
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def requests(layer) -> int:
    """The window's requests: its ``detect`` spans."""
    w0, w1 = layer["window"]
    return sum(w0 <= e["ts"] <= w1
               for e in tr.spans(layer["events"], "detect"))


def idle_inside(layer, ivs) -> float:
    """Microseconds in ``ivs`` with no kernel, copy or set on the device
    (the window's gaps, ``trace.busy_and_gaps``, clipped to them)."""
    _, gaps = tr.busy_and_gaps(layer["events"], *layer["window"])
    return sum(max(0.0, min(b, d) - max(a, c))
               for a, b in gaps for c, d in ivs)


def device_us(layer, ivs, cats=tr.DEVICE_CATS) -> float:
    """Microseconds of the device operations of ``cats`` whose launch lies
    inside ``ivs``."""
    return sum(e["dur"] for e in tr.launched_inside(layer["events"], ivs,
                                                    cats))


def launches(layer, ivs) -> int:
    """Runtime calls inside ``ivs`` that put work on the card."""
    return sum(1 for e in layer["events"]
               if e.get("ph") == "X"
               and e.get("cat") in ("cuda_runtime", "cuda_driver")
               and e.get("name", "").startswith(LAUNCHES)
               and any(a <= e["ts"] <= b for a, b in ivs))


def on_device(layer) -> bool:
    """Whether the trace recorded device work (none on a CPU run, whose
    host times are not the card's)."""
    return bool(layer.get("events") and tr.device_ops(layer["events"]))


def per_request(layer, names: Sequence[str], measure) -> Optional[float]:
    """``measure(layer, intervals of names)`` over the window's requests,
    or None without device activity, requests or such spans."""
    if not on_device(layer):
        return None
    n = requests(layer)
    ivs = intervals(layer, names)
    if not n or not ivs:
        return None
    return measure(layer, ivs) / n


def per_step_ms(layer, name: str, measure) -> Optional[float]:
    """``measure(layer, intervals of name)`` microseconds over the
    window's steps, in milliseconds, or None without device activity,
    steps or such spans."""
    steps = layer.get("steps")
    if not on_device(layer) or not steps:
        return None
    ivs = intervals(layer, [name])
    if not ivs:
        return None
    return measure(layer, ivs) / steps / 1e3
