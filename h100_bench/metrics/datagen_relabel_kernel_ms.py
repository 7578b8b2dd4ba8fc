"""datagen_relabel_kernel_ms: the device time (kernels, copies, sets)
launched inside the program's ``relabel`` spans (graph R's replay, every
candidate re-evaluated against the ground-truth cloud, and the read of its
labels), per data-generation view (``_datagen``)."""

from h100_bench.metrics import _datagen, _spans


def read(layer):
    return _datagen.per_view_ms(layer, ["relabel"], _spans.device_us)
