"""launches_per_request: the runtime calls that put work on the card
(kernel and graph launches, copies, sets) inside the program's
``read_file``, ``preprocess`` or ``detect`` spans, per request
(``_spans``)."""

from h100_bench.metrics import _spans


def read(layer):
    return _spans.per_request(layer, ["read_file", "preprocess", "detect"],
                              _spans.launches)
