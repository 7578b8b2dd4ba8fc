"""device_idle.train: the idle share of the traced window (``_idle``)."""

from h100_bench.metrics import _idle


def read(layer):
    return _idle.share(layer)
