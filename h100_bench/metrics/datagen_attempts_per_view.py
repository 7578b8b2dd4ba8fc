"""datagen_attempts_per_view: the attempts a traced view made (the
program's ``last_counts["attempts"]``), averaged over the traced views: each
attempt is one more A, B and R."""

from h100_bench.metrics import _datagen


def read(layer):
    units = _datagen.counters(layer)
    if units is None:
        return None
    return sum(u["attempts"] for u in units) / len(units)
