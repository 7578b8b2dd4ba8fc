"""cem_rounds_kernel_ms: the device time (kernels, copies, sets) launched
inside the program's ``cem_rounds`` spans (graph R's replay: round 0's
subsample and candidates, each draw and candidate pass), per CEM request
(``_cem``)."""

from h100_bench.metrics import _cem, _spans


def read(layer):
    return _cem.per_request_ms(layer, ["cem_rounds"], _spans.device_us)
