"""datagen_idle_ms: the device's idle time while the host is inside the
program's ``datagen_view`` spans (the hand-offs between each attempt's A,
its read, B, R and the labels' read, and the balance and the rows' copy),
per data-generation view (``_datagen``)."""

from h100_bench.metrics import _datagen, _spans


def read(layer):
    return _datagen.per_view_ms(layer, ["datagen_view"], _spans.idle_inside)
