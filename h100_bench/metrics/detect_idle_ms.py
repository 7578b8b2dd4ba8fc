"""detect_idle_ms: the device's idle time while the host is inside the
program's ``detect`` spans (the hand-offs between A, the read, B, C and
the result's read), per request (``_spans``)."""

from h100_bench.metrics import _spans


def read(layer):
    t = _spans.per_request(layer, ["detect"], _spans.idle_inside)
    return None if t is None else t / 1e3
