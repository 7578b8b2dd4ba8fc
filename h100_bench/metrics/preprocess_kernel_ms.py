"""preprocess_kernel_ms: the device time (kernels, copies, sets) launched
inside the program's ``preprocess`` spans, per request (``_spans``)."""

from h100_bench.metrics import _spans


def read(layer):
    t = _spans.per_request(layer, ["preprocess"], _spans.device_us)
    return None if t is None else t / 1e3
