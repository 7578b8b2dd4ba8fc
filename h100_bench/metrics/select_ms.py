"""select_ms: the mean host duration of the program's
``select_and_cluster`` spans in the trace (program C; the span ends in a
device sync, so it covers the device work)."""

from h100_bench import trace as tr


def read(layer):
    evs = layer.get("events")
    sp = tr.spans(evs, "select_and_cluster") if evs else []
    return sum(e["dur"] for e in sp) / len(sp) / 1e3 if sp else None
