"""cem_live_image_share: the valid hands of every round over the image
slots the scoring passes computed (the program's ``last_counts``:
``live_hands`` over ``image_slots``), summed over the traced requests, in
percent: the share of the six scoring passes' images that is real work."""

from h100_bench.metrics import _cem


def read(layer):
    reqs = _cem.counters(layer)
    if reqs is None:
        return None
    slots = sum(q["image_slots"] for q in reqs)
    return sum(q["live_hands"] for q in reqs) / slots * 100.0 if slots \
        else None
