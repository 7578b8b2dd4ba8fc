"""preprocess_idle_ms: the device's idle time while the host is inside the
program's ``read_file`` or ``preprocess`` spans, per request (``_spans``)."""

from h100_bench.metrics import _spans


def read(layer):
    t = _spans.per_request(layer, ["read_file", "preprocess"],
                           _spans.idle_inside)
    return None if t is None else t / 1e3
