"""cem_idle_ms: the device's idle time while the host is inside the
program's ``cem_detect`` spans (the hand-offs around and between the two
graph launches and the read), per CEM request (``_cem``)."""

from h100_bench.metrics import _cem, _spans


def read(layer):
    return _cem.per_request_ms(layer, ["cem_detect"], _spans.idle_inside)
