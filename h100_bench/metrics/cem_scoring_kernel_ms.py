"""cem_scoring_kernel_ms: the device time (kernels, copies, sets) launched
inside the program's ``cem_scoring`` spans (graph S's replay: every
round's descriptors, images and LeNet, the prune and the selection; and
the request's one read), per CEM request (``_cem``)."""

from h100_bench.metrics import _cem, _spans


def read(layer):
    return _cem.per_request_ms(layer, ["cem_scoring"], _spans.device_us)
