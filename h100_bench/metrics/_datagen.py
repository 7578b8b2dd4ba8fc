"""The data-generation cell's readers' helpers: the program's spans per
view, counted by the window's ``datagen_view`` spans (one an (object,
view) unit: the job runs one unit at a time), and the traced views'
counters."""

from typing import Optional, Sequence

from h100_bench import trace as tr
from h100_bench.metrics import _spans


def views(layer) -> int:
    """The window's units: its ``datagen_view`` spans."""
    w0, w1 = layer["window"]
    return sum(w0 <= e["ts"] <= w1
               for e in tr.spans(layer["events"], "datagen_view"))


def per_view_ms(layer, names: Sequence[str], measure) -> Optional[float]:
    """``measure(layer, intervals of names)`` microseconds over the
    window's units, in milliseconds, or None without device activity,
    units or such spans."""
    if not _spans.on_device(layer):
        return None
    n = views(layer)
    ivs = _spans.intervals(layer, names)
    if not n or not ivs:
        return None
    return measure(layer, ivs) / n / 1e3


def counters(layer) -> Optional[list]:
    """The traced units' latencies and counters (``last_counts``), or None
    where the program keeps no such counters or nothing ran on the card."""
    units = layer.get("views")
    if not units or not _spans.on_device(layer) or not all(
            "attempts" in u and "kept" in u for u in units):
        return None
    return units
