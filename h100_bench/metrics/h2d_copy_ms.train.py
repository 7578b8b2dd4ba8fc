"""h2d_copy_ms.train: host-to-device copy time per traced step (the
blocks moved to the card each epoch, the evaluation batches), from the
trace."""

from h100_bench.metrics import _copies


def read(layer):
    return _copies.per_unit_ms(layer, "HtoD", "steps")
