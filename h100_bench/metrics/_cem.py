"""The CEM cell's readers' helpers: the program's spans per CEM request,
counted by the window's ``cem_detect`` spans (one a request: the client
sends one request at a time), and the traced requests' counters."""

from typing import Optional, Sequence

from h100_bench import trace as tr
from h100_bench.metrics import _spans


def requests(layer) -> int:
    """The window's CEM requests: its ``cem_detect`` spans."""
    w0, w1 = layer["window"]
    return sum(w0 <= e["ts"] <= w1
               for e in tr.spans(layer["events"], "cem_detect"))


def per_request_ms(layer, names: Sequence[str], measure) -> Optional[float]:
    """``measure(layer, intervals of names)`` microseconds over the
    window's CEM requests, in milliseconds, or None without device
    activity, requests or such spans."""
    if not _spans.on_device(layer):
        return None
    n = requests(layer)
    ivs = _spans.intervals(layer, names)
    if not n or not ivs:
        return None
    return measure(layer, ivs) / n / 1e3


def counters(layer) -> Optional[list]:
    """The traced requests' latencies and counters (``last_counts``), or
    None where the program keeps no such counters or nothing ran on the
    card."""
    reqs = layer.get("cem_requests")
    if not reqs or not _spans.on_device(layer) or not all(
            "live_hands" in q and "image_slots" in q for q in reqs):
        return None
    return reqs
