"""train_eval_ms: the host time of the program's ``train_eval`` spans
(each evaluation of the test set, which ends in a read), per window step
(``_spans``)."""

from h100_bench.metrics import _spans


def read(layer):
    return _spans.per_step_ms(layer, "train_eval",
                              lambda lay, ivs: sum(b - a for a, b in ivs))
