"""score_kernel_ms: the kernel time launched inside the program's
``score`` spans (program B's graph: descriptors, images, LeNet), per
request (``_spans``)."""

from h100_bench.metrics import _spans


def read(layer):
    t = _spans.per_request(
        layer, ["score"], lambda lay, ivs: _spans.device_us(lay, ivs,
                                                            ("kernel",)))
    return None if t is None else t / 1e3
